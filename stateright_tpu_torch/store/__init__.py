"""The tiered state store and the warm-start corpus (the JAX package's
`stateright_tpu/store/`): the device table is the hot tier, host
RAM the cold tier, and a Bloom summary of the spilled set keeps the common
probe on the device.

- `summary` — the Bloom summary words: `host_insert` sets bits at eviction,
  `maybe_contains` tests them (numpy or torch); the CUDA insert kernel
  tests them itself in its fused form (verdict 3).
- `host` — `HostSpillStore`, the cold tier: packed uint64 fingerprints and
  parents, first-writer dedup, exact membership and parents by binary
  search.
- `tiered` — `TieredConfig`, `TieredStore`: high/low-water eviction of
  non-full table rows, suspect resolution, per-tier counters, and the
  corpus preload.
- `corpus` — `CorpusStore`: the cross-job warm-start corpus of published
  visited sets, content-addressed; `warm` — the one warm-start seam (the
  preloads and the rung gates); `specdelta` — the definition digests and
  the Spec-CI salvage rules.

Import the submodules directly; this package file imports none of them, so
that the tensor modules can import the store lazily without a cycle.
"""
