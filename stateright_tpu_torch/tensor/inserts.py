"""The insert-variant dispatch: variant name -> insert function, the one
resolution point the engine and the table handle call (the JAX package's
`tensor/inserts.py`). This slice has one variant, "pallas": the CUDA kernel
for tensors on a CUDA device, its plain torch version for tensors on the
CPU. There is no other rule and no fallback: a CUDA tensor always goes to
the kernel, and a failed build or launch raises. Both forms of the insert go
the same way: with a `summary` (the tiered store's Bloom words) the call is
the fused Bloom-suspect form, on the card too — never the plain kernel
followed by a separate `maybe_contains` pass.
"""

from __future__ import annotations

from ..knobs import INSERT_VARIANTS
from .pallas_hashtable import insert_kernel, insert_plain, partitions


def _insert_pallas(t_key, t_parent, key, parent, active, n_partitions=None,
                   summary=None, summary_cfg=None):
    args = (t_key, t_parent, key, parent, active, n_partitions, summary, summary_cfg)
    if t_key.device.type == "cuda":
        return insert_kernel(*args)
    if t_key.device.type == "cpu":
        return insert_plain(*args)
    raise ValueError(f"no visited-set insert for device {t_key.device}")


INSERT_TABLE = {"pallas": _insert_pallas}


def check_table_log2(table_log2: int) -> None:
    """The table must hold at least one 128-slot bucket."""
    partitions(1 << table_log2)


def resolve_insert(insert_variant: str):
    if insert_variant not in INSERT_VARIANTS:  # knob universe: knobs.py
        raise ValueError(
            f"insert_variant must be one of {INSERT_VARIANTS}, "
            f"got {insert_variant!r}"
        )
    return INSERT_TABLE[insert_variant]
