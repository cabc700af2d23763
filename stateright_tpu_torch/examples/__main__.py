"""The example CLIs: `python -m stateright_tpu_torch.examples <example>
<subcommand> [args] [--device cpu]`, one command for the root `examples/`
scripts of the JAX package (ref: the reference's examples/*.rs mains).

Each example keeps its script's subcommands, arguments, USAGE lines and
report output; `check-tpu` is `check-cuda` and `check-tpu-sym` is
`check-cuda-sym`, on the card unless `--device cpu` is given (see `_cli.py`).
`spawn` runs the actors for real over UDP; `explore` serves the Explorer.
"""

from __future__ import annotations

import sys
from typing import Optional

from ._cli import CliArgs, network_names, report, thread_count, usage

# -- two-phase commit (ref: examples/2pc.rs:172-253) ---------------------------


def two_phase_commit(a: CliArgs) -> None:
    from .two_phase_commit import TwoPhaseSys

    cmd = a.subcommand()
    if cmd == "check":
        rm_count = a.int(2, 2)
        print(f"Checking two phase commit with {rm_count} resource managers.")
        report(TwoPhaseSys(rm_count).checker().threads(thread_count()).spawn_dfs())
    elif cmd == "check-bfs":
        rm_count = a.int(2, 2)
        print(f"Checking two phase commit with {rm_count} resource managers.")
        report(TwoPhaseSys(rm_count).checker().threads(thread_count()).spawn_bfs())
    elif cmd == "check-cuda":
        rm_count = a.int(2, 2)
        device = a.device()
        print(
            f"Checking two phase commit with {rm_count} resource managers "
            "on the device frontier checker."
        )
        from ..tensor.models import TensorTwoPhaseSys

        report(TensorTwoPhaseSys(rm_count).checker().spawn_cuda(device=device))
    elif cmd == "check-sym":
        rm_count = a.int(2, 2)
        print(
            f"Checking two phase commit with {rm_count} resource managers "
            "using symmetry reduction."
        )
        report(
            TwoPhaseSys(rm_count).checker().threads(thread_count()).symmetry().spawn_dfs()
        )
    elif cmd == "explore":
        rm_count = a.int(2, 2)
        address = a.str(3, "localhost:3000")
        print(
            f"Exploring state space for two phase commit with {rm_count} "
            f"resource managers on {address}."
        )
        TwoPhaseSys(rm_count).checker().serve(address, block=True)
    else:
        usage("2pc", [
            "check [RESOURCE_MANAGER_COUNT]",
            "check-bfs [RESOURCE_MANAGER_COUNT]",
            "check-cuda [RESOURCE_MANAGER_COUNT]",
            "check-sym [RESOURCE_MANAGER_COUNT]",
            "explore [RESOURCE_MANAGER_COUNT] [ADDRESS]",
        ])


# -- increment (ref: examples/increment.rs:203-258) -----------------------------


def increment(a: CliArgs) -> None:
    from .increment import IncrementSys

    cmd = a.subcommand()
    if cmd == "check":
        n = a.int(2, 3)
        print(f"Model checking increment with {n} threads.")
        report(IncrementSys(n).checker().threads(thread_count()).spawn_dfs())
    elif cmd == "check-sym":
        n = a.int(2, 3)
        print(f"Model checking increment with {n} threads using symmetry reduction.")
        report(IncrementSys(n).checker().threads(thread_count()).symmetry().spawn_dfs())
    elif cmd == "explore":
        n = a.int(2, 3)
        address = a.str(3, "localhost:3000")
        print(f"Exploring the state space of increment with {n} threads on {address}.")
        IncrementSys(n).checker().serve(address, block=True)
    else:
        usage("increment", [
            "check [THREAD_COUNT]",
            "check-sym [THREAD_COUNT]",
            "explore [THREAD_COUNT] [ADDRESS]",
        ])


# -- increment with a lock (ref: examples/increment_lock.rs) --------------------


def increment_lock(a: CliArgs) -> None:
    from .increment import IncrementLockSys

    cmd = a.subcommand()
    if cmd == "check":
        n = a.int(2, 3)
        print(f"Model checking increment_lock with {n} threads.")
        report(IncrementLockSys(n).checker().threads(thread_count()).spawn_dfs())
    elif cmd == "check-sym":
        n = a.int(2, 3)
        print(f"Model checking increment_lock with {n} threads using symmetry reduction.")
        report(
            IncrementLockSys(n).checker().threads(thread_count()).symmetry().spawn_dfs()
        )
    elif cmd in ("check-cuda", "check-cuda-sym"):
        n = a.int(2, 3)
        sym = cmd == "check-cuda-sym"
        device = a.device()
        print(
            f"Model checking increment_lock with {n} threads on the device "
            f"frontier checker{' using symmetry reduction' if sym else ''}."
        )
        from ..tensor.models import TensorIncrementLock

        report(
            TensorIncrementLock(n, symmetry=sym)
            .checker()
            .spawn_cuda(batch_size=1024, table_log2=14, device=device)
        )
    elif cmd == "explore":
        n = a.int(2, 3)
        address = a.str(3, "localhost:3000")
        print(f"Exploring the state space of increment_lock with {n} threads on {address}.")
        IncrementLockSys(n).checker().serve(address, block=True)
    else:
        usage("increment_lock", [
            "check [THREAD_COUNT]",
            "check-sym [THREAD_COUNT]",
            "check-cuda [THREAD_COUNT]",
            "check-cuda-sym [THREAD_COUNT]",
            "explore [THREAD_COUNT] [ADDRESS]",
        ])


# -- external input (ref: examples/interaction.rs:17-68) ------------------------


def interaction(a: CliArgs) -> None:
    from .interaction import build_model

    cmd = a.subcommand()
    if cmd == "check":
        # target_max_depth bounds the loosely-bounded space
        # (ref: examples/interaction.rs:43).
        checker = (
            build_model().checker().threads(thread_count()).target_max_depth(30).spawn_bfs()
        )
        report(checker)
        checker.assert_properties()
    elif cmd == "explore":
        address = a.str(2, "0.0.0.0:3000")
        build_model().checker().target_max_depth(30).serve(address, block=True)
    else:
        usage("interaction", ["check", "explore"])


# -- ABD linearizable register (ref: examples/linearizable-register.rs:252-334)


def linearizable_register(a: CliArgs) -> None:
    from .abd import AbdModelCfg

    cmd = a.subcommand()
    if cmd == "check":
        client_count = a.int(2, 2)
        network = a.network(3)
        print(f"Model checking a linearizable register with {client_count} clients.")
        report(
            AbdModelCfg(client_count=client_count, server_count=3, network=network)
            .into_model()
            .checker()
            .threads(thread_count())
            .spawn_dfs()
        )
    elif cmd == "explore":
        client_count = a.int(2, 2)
        address = a.str(3, "localhost:3000")
        network = a.network(4)
        print(
            f"Exploring state space for linearizable register with "
            f"{client_count} clients on {address}."
        )
        AbdModelCfg(
            client_count=client_count, server_count=3, network=network
        ).into_model().checker().serve(address, block=True)
    elif cmd == "spawn":
        from ..actor import Id
        from ..actor.register import Get, GetOk, Internal, Put, PutOk
        from ..actor.spawn import spawn
        from .abd import AbdActor, AckQuery, AckRecord, Query, Record

        port = 3000
        print("  A server that implements a linearizable register.")
        print(f"  Interact via UDP JSON, e.g. nc -u localhost {port}")
        ids = [Id.from_addr("127.0.0.1", port + i) for i in range(3)]
        spawn(
            [(ids[i], AbdActor([pid for pid in ids if pid != ids[i]])) for i in range(3)],
            msg_types=[Put, Get, PutOk, GetOk, Internal, Query, AckQuery, Record, AckRecord],
        )
    else:
        usage("linearizable_register", [
            "check [CLIENT_COUNT] [NETWORK]",
            "explore [CLIENT_COUNT] [ADDRESS] [NETWORK]",
            "spawn",
        ])
        print(f"NETWORK: {network_names()}")


# -- last-writer-wins register (ref: examples/lww-register.rs:188-262) ----------


def lww_register(a: CliArgs) -> None:
    from .lww_register import build_model

    cmd = a.subcommand()
    if cmd == "check":
        client_count = a.int(2, 2)
        depth = a.int(3, 8)
        report(build_model(client_count).checker().target_max_depth(depth).spawn_dfs())
    elif cmd == "explore":
        client_count = a.int(2, 2)
        address = a.str(3, "localhost:3000")
        print(
            f"Exploring state space for last-writer-wins register with "
            f"{client_count} clients on {address}."
        )
        build_model(client_count).checker().serve(address, block=True)
    elif cmd == "spawn":
        from ..actor import Id
        from ..actor.spawn import spawn
        from .lww_register import LwwActor, LwwRegister

        port = 3000
        ids = [Id.from_addr("127.0.0.1", port + i) for i in range(3)]
        print("  A server that implements a last-writer-wins register.")
        spawn(
            [(ids[i], LwwActor([pid for pid in ids if pid != ids[i]])) for i in range(3)],
            msg_types=[LwwRegister],
        )
    else:
        usage("lww_register", [
            "check [CLIENT_COUNT] [DEPTH]",
            "explore [CLIENT_COUNT] [ADDRESS]",
            "spawn",
        ])


# -- single-decree Paxos (ref: examples/paxos.rs:354-510) -----------------------


def paxos(a: CliArgs) -> None:
    from .paxos import PaxosModelCfg

    cmd = a.subcommand()
    if cmd in ("check", "check-bfs", "check-dfs"):
        client_count = a.int(2, 2)
        network = a.network(3)
        print(f"Model checking Single Decree Paxos with {client_count} clients.")
        builder = (
            PaxosModelCfg(client_count=client_count, server_count=3, network=network)
            .into_model()
            .checker()
            .threads(thread_count())
        )
        report(builder.spawn_dfs() if cmd == "check-dfs" else builder.spawn_bfs())
    elif cmd == "check-cuda":
        client_count = a.int(2, 2)
        if client_count > 3:
            print(
                "The hand tensor encoding supports at most 3 clients; for "
                "bigger configs lower the actor model generically "
                "(stateright_tpu_torch.tensor.refine_check or closure='exact')."
            )
            return
        device = a.device()
        print(
            f"Model checking Single Decree Paxos with {client_count} clients "
            "on the device frontier checker."
        )
        from ..tensor.paxos import TensorPaxos

        batch, table = (2048, 16) if client_count <= 2 else (8192, 22)
        report(
            TensorPaxos(client_count=client_count)
            .checker()
            .spawn_cuda(batch_size=batch, table_log2=table, device=device)
        )
    elif cmd == "check-simulation":
        client_count = a.int(2, 2)
        network = a.network(3)
        print(f"Model checking Single Decree Paxos with {client_count} clients.")
        report(
            PaxosModelCfg(client_count=client_count, server_count=3, network=network)
            .into_model()
            .checker()
            .threads(thread_count())
            .timeout(10.0)
            .spawn_simulation(0)
        )
    elif cmd == "explore":
        client_count = a.int(2, 2)
        address = a.str(3, "localhost:3000")
        network = a.network(4)
        print(
            f"Exploring state space for Single Decree Paxos with "
            f"{client_count} clients on {address}."
        )
        PaxosModelCfg(
            client_count=client_count, server_count=3, network=network
        ).into_model().checker().serve(address, block=True)
    elif cmd == "spawn":
        from ..actor import Id
        from ..actor.spawn import spawn
        from .paxos import PaxosActor

        port = 3000
        print("  A set of servers that implement Single Decree Paxos.")
        print("  You can monitor and interact using tcpdump and netcat, e.g.")
        print(f"$ nc -u localhost {port}")
        print('  {"Put": [1, "X"]}')
        print('  {"Get": [2]}')
        ids = [Id.from_addr("127.0.0.1", port + i) for i in range(3)]
        spawn(
            [(ids[i], PaxosActor([pid for pid in ids if pid != ids[i]])) for i in range(3)],
            msg_types=paxos_msg_types(),
        )
    else:
        usage("paxos", [
            "check-dfs [CLIENT_COUNT] [NETWORK]",
            "check-bfs [CLIENT_COUNT] [NETWORK]",
            "check-simulation [CLIENT_COUNT] [NETWORK]",
            "check-cuda [CLIENT_COUNT<=3]",
            "explore [CLIENT_COUNT] [ADDRESS] [NETWORK]",
            "spawn",
        ])
        print(f"NETWORK: {network_names()}")


def paxos_msg_types() -> list:
    """The classes a spawned Paxos cluster's JSON serde decodes."""
    from ..actor.register import Get, GetOk, Internal, Put, PutOk
    from .paxos import Accept, Accepted, Decided, Prepare, Prepared

    return [Put, Get, PutOk, GetOk, Internal, Prepare, Prepared, Accept, Accepted, Decided]


# -- Raft leader election (the device simulation's model-zoo workload) ----------


def raft(a: CliArgs) -> None:
    cmd = a.subcommand()
    if cmd == "check":
        n = a.int(2, 3)
        max_term = a.int(3, 3)
        device = a.device()
        print(
            f"Checking Raft leader election with {n} servers, "
            f"terms <= {max_term} (exhaustive device frontier checker)."
        )
        from ..tensor.models import TensorRaft

        report(TensorRaft(n, max_term).checker().spawn_cuda(device=device))
    elif cmd == "simulate":
        n = a.int(2, 5)
        max_term = a.int(3, 5)
        device = a.device()
        print(
            f"Simulating Raft leader election with {n} servers, "
            f"terms <= {max_term} (device random walks, shared visited "
            "table)."
        )
        from ..core.discovery import HasDiscoveries
        from ..tensor.models import TensorRaft

        report(
            TensorRaft(n, max_term)
            .checker()
            .finish_when(HasDiscoveries.ANY)
            .target_state_count(2_000_000)
            .spawn_cuda(
                mode="simulation",
                traces=2048,
                max_depth=256,
                dedup="shared",
                table_log2=22,
                device=device,
            )
        )
    else:
        usage("raft", [
            "check [SERVER_COUNT] [MAX_TERM]",
            "simulate [SERVER_COUNT] [MAX_TERM]",
        ])


# -- single-copy register (ref: examples/single-copy-register.rs:139-231) -------


def single_copy_register(a: CliArgs) -> None:
    from .single_copy_register import SingleCopyModelCfg

    cmd = a.subcommand()
    if cmd == "check":
        client_count = a.int(2, 2)
        network = a.network(3)
        print(f"Model checking a single-copy register with {client_count} clients.")
        report(
            SingleCopyModelCfg(client_count=client_count, server_count=1, network=network)
            .into_model()
            .checker()
            .threads(thread_count())
            .spawn_dfs()
        )
    elif cmd == "explore":
        client_count = a.int(2, 2)
        address = a.str(3, "localhost:3000")
        network = a.network(4)
        print(
            f"Exploring state space for single-copy register with "
            f"{client_count} clients on {address}."
        )
        SingleCopyModelCfg(
            client_count=client_count, server_count=1, network=network
        ).into_model().checker().serve(address, block=True)
    elif cmd == "spawn":
        from ..actor import Id
        from ..actor.register import Get, GetOk, Put, PutOk
        from ..actor.spawn import spawn
        from .single_copy_register import SingleCopyActor

        port = 3000
        print("  A server that implements a single-copy register.")
        print(f"  Interact via UDP JSON, e.g. nc -u localhost {port}")
        spawn(
            [(Id.from_addr("127.0.0.1", port), SingleCopyActor())],
            msg_types=[Put, Get, PutOk, GetOk],
        )
    else:
        usage("single_copy_register", [
            "check [CLIENT_COUNT]",
            "explore [CLIENT_COUNT] [ADDRESS] [NETWORK]",
            "spawn",
        ])
        print(f"NETWORK: {network_names()}")


# -- timer-driven pingers (ref: examples/timers.rs:119-165) ---------------------


def timers(a: CliArgs) -> None:
    from .timers import PingerModelCfg

    cmd = a.subcommand()
    if cmd == "check":
        network = a.network(2)
        print("Model checking Pingers")
        report(
            PingerModelCfg(server_count=3, network=network)
            .into_model()
            .checker()
            .threads(thread_count())
            .spawn_dfs()
        )
    elif cmd == "explore":
        address = a.str(2, "localhost:3000")
        network = a.network(3)
        print(f"Exploring state space for Pingers on {address}.")
        PingerModelCfg(server_count=3, network=network).into_model().checker().serve(
            address, block=True
        )
    else:
        usage("timers", ["check [NETWORK]", "explore [ADDRESS] [NETWORK]"])
        print(f"NETWORK: {network_names()}")


EXAMPLES = {
    "2pc": two_phase_commit,
    "increment": increment,
    "increment_lock": increment_lock,
    "interaction": interaction,
    "linearizable_register": linearizable_register,
    "lww_register": lww_register,
    "paxos": paxos,
    "raft": raft,
    "single_copy_register": single_copy_register,
    "timers": timers,
}


def main(argv: Optional[list] = None) -> int:
    """Run one example's subcommand; `argv` is the words after the module
    name (`["2pc", "check-cuda", "3"]`). Returns the exit code."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in EXAMPLES:
        from ._cli import PROG

        print("USAGE:")
        print(f"  {PROG} <EXAMPLE> <SUBCOMMAND> [ARGS] [--device cpu]")
        print(f"EXAMPLE: {' | '.join(EXAMPLES)}")
        return 0 if not argv else 2
    EXAMPLES[argv[0]](CliArgs(argv[0], argv[1:]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
