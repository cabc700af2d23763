"""Multi-device search: `ShardedSearch`, the fingerprint-sharded engine
with its all-to-all successor exchange over a `torch.distributed` group
(the JAX package's `parallel/`), and the group's set-up: `init_world()`
under torchrun, `run_world()` for ranks spawned on this host."""

from .sharded import ShardedSearch
from .world import init_world, run_world

__all__ = ["ShardedSearch", "init_world", "run_world"]
