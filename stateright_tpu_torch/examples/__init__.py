"""Actor workloads of the JAX package's `examples/` that the port lowers to
the device (tensor/lowering.py): single-decree Paxos, the ABD register, the
single-copy register and the timer-driven pingers. Port-owned copies."""
