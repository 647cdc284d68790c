"""Durable per-document homes: the WAL and snapshot store (`store.py`),
the paged store (`pages.py`), the tiered store with its fault injection
and quarantine (`tier.py`) and the storage soak (`soak.py`, also
`python -m diamond_types_tpu_torch.storage.soak`). Copies of the JAX
package's `storage/`: the files on disk are byte-identical."""
