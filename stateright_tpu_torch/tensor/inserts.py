"""The insert-variant dispatch: variant name (and table layout) -> insert
function, the one resolution point the engines and the table handles call
(the JAX package's `tensor/inserts.py`). `knobs.py` owns the names, this
module the dispatch, and `knobs.check_registry()` pins the two together.

- "pallas" is the registered op `stateright_tpu_torch::visited_insert`
  (tensor/pallas_hashtable.py), whose CUDA implementation is the kernel and
  whose CPU implementation is its plain torch version; with a `summary`
  (the tiered store's Bloom words) the call is the fused Bloom-suspect
  form, `::visited_insert_bloom`. It is every engine's default;
- "sort", "phased", "capped" and "capped-phased" are the JAX package's XLA
  designs as torch ops (tensor/hashtable.py), on the split layout, and
  "sort" and "capped" on the kv layout too. They run on any device, each
  only when asked for by name.

There is no fallback either way: a design never becomes the kernel, and the
kernel never becomes a design. Every entry shares one signature,

    insert(table, t_parent, key, parent, active)
        -> (table, t_parent, is_new, overflow)

with the tables updated in place; the pallas entry also takes
`n_partitions`, `summary` and `summary_cfg`. A design resolved for the
tiered store (`resolve_insert(..., summary_cfg=)`) takes `summary` and
`summary_cfg` too, so every engine calls every variant's tiered form the
same way.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from ..knobs import INSERT_VARIANTS, PHASED_VARIANTS, TABLE_LAYOUTS
from . import hashtable, pallas_hashtable
from .fingerprint import MASK32
from .hashtable import (
    HashTable,
    HashTableKV,
    _insert_impl,
    _insert_impl_capped,
    _insert_impl_kv,
    _insert_impl_kv_capped,
    _insert_impl_phased,
    _insert_impl_phased_capped,
)
from .pallas_hashtable import PallasHashTable, insert_op, partitions


def _insert_pallas(t_key, t_parent, key, parent, active, n_partitions=None,
                   summary=None, summary_cfg=None):
    if t_key.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no visited-set insert for device {t_key.device}")
    return insert_op(t_key, t_parent, key, parent, active, n_partitions, summary, summary_cfg)


#: split-layout dispatch: the keys are exactly knobs.INSERT_VARIANTS.
INSERT_TABLE = {
    "sort": _insert_impl,
    "phased": _insert_impl_phased,
    "capped": _insert_impl_capped,
    "capped-phased": _insert_impl_phased_capped,
    "pallas": _insert_pallas,
}

#: kv-layout dispatch: the designs with a kv form.
KV_INSERT_TABLE = {
    "sort": _insert_impl_kv,
    "capped": _insert_impl_kv_capped,
}


def _check_names(insert_variant: str, table_layout: str) -> None:
    if table_layout not in TABLE_LAYOUTS:  # knob universe: knobs.py
        raise ValueError(f"table_layout must be one of {TABLE_LAYOUTS}, got {table_layout!r}")
    if insert_variant not in INSERT_VARIANTS:  # knob universe: knobs.py
        raise ValueError(
            f"insert_variant must be one of {INSERT_VARIANTS}, got {insert_variant!r}"
        )
    if table_layout == "kv" and insert_variant not in KV_INSERT_TABLE:
        raise ValueError(
            f"insert_variant={insert_variant!r} supports the split table layout only"
        )


def check_table_log2(insert_variant: str, table_log2: int) -> None:
    """The constructors' size guard. Only "pallas" has a floor: its table
    must hold one 128-slot bucket (pallas_hashtable.partitions). The
    designs take any power-of-two table (tiny ones shrink to one bucket)."""
    if insert_variant == "pallas":
        partitions(1 << table_log2)
    elif table_log2 < 0:
        raise ValueError(f"table_log2 must be >= 0, got {table_log2}")


def make_table(insert_variant: str, table_log2: int, device="cuda",
               table_layout: str = "split"):
    """The host table handle of a variant: `PallasHashTable` (its own slot
    layout, so every insert into it, seeding included, is the kernel's), or
    a design's `HashTable` / `HashTableKV`."""
    _check_names(insert_variant, table_layout)
    check_table_log2(insert_variant, table_log2)
    if insert_variant == "pallas":
        return PallasHashTable(table_log2, device=device)
    cls = HashTableKV if table_layout == "kv" else HashTable
    return cls(table_log2, insert_variant, device=device)


def _probe_after(insert):
    """A design's insert in the kernel's tiered signature: with a `summary`
    it inserts, then marks the new keys that hit the Bloom summary
    (`is_new & maybe_contains`, the JAX package's order for a design) and
    returns (table, t_parent, is_new, suspect, overflow); without one it is
    the plain insert."""

    def tiered(table, t_parent, key, parent, active, summary=None, summary_cfg=None):
        out = insert(table, t_parent, key, parent, active)
        if summary is None:
            return out
        from ..store.summary import maybe_contains

        table, t_parent, is_new, overflow = out
        hit = maybe_contains(summary, key & MASK32, (key >> 32) & MASK32, *summary_cfg)
        return table, t_parent, is_new, is_new & hit, overflow

    return tiered


def resolve_insert(insert_variant: str, table_layout: str = "split", *, summary_cfg=None):
    """variant name (and layout) -> insert function. JAX's refusals: an
    unknown name, and "phased", "capped-phased" or "pallas" on the kv
    layout. `summary_cfg=(summary_log2, hashes)` asks for the tiered form:
    called with `summary=` and `summary_cfg=`, it returns the suspect mask
    (the new keys that hit the summary) before `overflow`. The kernel
    ("pallas") probes inside its own pass; a design inserts, then probes
    with `store.summary.maybe_contains`, as the JAX package does."""
    _check_names(insert_variant, table_layout)
    if table_layout == "kv":
        return KV_INSERT_TABLE[insert_variant]
    if summary_cfg is not None and insert_variant != "pallas":
        return _probe_after(INSERT_TABLE[insert_variant])
    return INSERT_TABLE[insert_variant]


def regrow_insert(insert_variant: str):
    """The insert a regrow re-inserts a table's keys through (the JAX
    `resident._regrow_insert`): the kernel for a "pallas" table, whose slot
    layout is its own, and the "sort" design for every design's table, since
    the designs share one bucket layout."""
    return INSERT_TABLE["pallas" if insert_variant == "pallas" else "sort"]


class TableReader(NamedTuple):
    """How an engine reads its table by key, for one variant and layout:
    `find_slots(table, key)` (-1 absent), `lookup(table, t_parent, key)`
    (0 absent), `dump(table, t_parent)` ({key: parent}), `clear(table,
    t_parent, slots)`, `occupied(table)` (bool[S]) and `slot_keys(table)`
    (int64[S], the key of each slot)."""

    find_slots: Callable
    lookup: Callable
    dump: Callable
    clear: Callable
    occupied: Callable
    slot_keys: Callable


def _clear_pallas(t_key, t_parent, slots) -> None:
    t_key.index_fill_(0, slots, 0)
    t_parent.index_fill_(0, slots, 0)


PALLAS_READER = TableReader(
    find_slots=pallas_hashtable.find_slots,
    lookup=pallas_hashtable.lookup,
    dump=pallas_hashtable.dump_table,
    clear=_clear_pallas,
    occupied=lambda t_key: t_key != 0,
    slot_keys=lambda t_key: t_key,
)


def _design_reader(layout: str) -> TableReader:
    return TableReader(
        find_slots=lambda table, key: hashtable.find_slots(table, key, layout),
        lookup=lambda table, t_parent, key: hashtable.lookup(table, t_parent, key, layout),
        dump=lambda table, t_parent: hashtable.dump(table, t_parent, layout),
        clear=lambda table, t_parent, slots: hashtable.clear_slots(table, t_parent, slots,
                                                                   layout),
        occupied=lambda table: hashtable.occupied(table, layout),
        slot_keys=lambda table: hashtable.slot_keys(table, layout),
    )


_READERS = {"split": _design_reader("split"), "kv": _design_reader("kv")}


def resolve_reader(insert_variant: str, table_layout: str = "split") -> TableReader:
    """The `TableReader` of a variant's table: the kernel's slot layout
    for "pallas", the designs' bucket chains (split or kv) otherwise."""
    _check_names(insert_variant, table_layout)
    return PALLAS_READER if insert_variant == "pallas" else _READERS[table_layout]

