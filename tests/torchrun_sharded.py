"""A sharded 2pc-3 check under torchrun, on the CPU over gloo:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        tests/torchrun_sharded.py

Each rank joins the group torchrun describes (`init_world`); rank 0 prints
one JSON line with the counts, the per-shard uniques, the steps and the
discoveries (tests/test_torch_sharded.py holds it against the JAX engine).
"""

import json

import torch.distributed as dist

from stateright_tpu_torch.parallel import ShardedSearch, init_world
from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

if __name__ == "__main__":
    device = init_world("cpu")
    try:
        r = ShardedSearch(TensorTwoPhaseSys(3), device=device, batch_size=64,
                          table_log2=12).run()
        if dist.get_rank() == 0:
            print(json.dumps({
                "generated": r.state_count, "unique": r.unique_state_count,
                "per_chip_unique": r.detail["per_chip_unique"], "steps": r.steps,
                "complete": r.complete, "discoveries": sorted(r.discoveries),
            }), flush=True)
    finally:
        dist.destroy_process_group()
