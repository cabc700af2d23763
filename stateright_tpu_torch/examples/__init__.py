"""The JAX package's `examples/` as port-owned copies: the actor workloads
the port lowers to the device (tensor/lowering.py: single-decree Paxos, the
ABD register, the single-copy register, the timer-driven pingers), the
host models (two-phase commit, increment, increment-lock), the
external-input and last-writer-wins actor systems, and the example CLIs
(`python -m stateright_tpu_torch.examples <example> <subcommand> [args]`,
see `__main__.py`)."""
