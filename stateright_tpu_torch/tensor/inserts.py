"""The insert-variant dispatch: variant name -> insert function, the one
resolution point the engine and the table handle call (the JAX package's
`tensor/inserts.py`). This slice has one variant, "pallas": the registered
op `stateright_tpu_torch::visited_insert` (tensor/pallas_hashtable.py),
whose CUDA implementation is the kernel and whose CPU implementation is its
plain torch version. There is no other rule and no fallback: a CUDA tensor
always goes to the kernel, a failed build or launch raises, and any other
device raises here. Both forms of the insert go the same way: with a
`summary` (the tiered store's Bloom words) the call is the fused
Bloom-suspect form, `::visited_insert_bloom`, on the card too — never the
plain kernel followed by a separate `maybe_contains` pass.
"""

from __future__ import annotations

from ..knobs import INSERT_VARIANTS
from .pallas_hashtable import insert_op, partitions


def _insert_pallas(t_key, t_parent, key, parent, active, n_partitions=None,
                   summary=None, summary_cfg=None):
    if t_key.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no visited-set insert for device {t_key.device}")
    return insert_op(t_key, t_parent, key, parent, active, n_partitions, summary, summary_cfg)


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
