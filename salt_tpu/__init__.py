"""salt_tpu — an SNP-aware short-read alignment engine in JAX.

A from-scratch rebuild of the capabilities of the `salt` aligner
(C/pthreads/SSE2) as batched JAX/XLA array programs:

* the SNP-augmented FM-index (C-part genome BWT + R-part local-pattern BWT)
  becomes bit-plane rank tables + full suffix-array gather tables laid out
  for vectorized HBM gathers,
* seeding/locate/verify run as fixed-shape batched device kernels,
* SAM emission is reproduced byte-for-byte on the host,
* scale-out uses `jax.sharding` meshes (reads data-parallel, index
  replicated or sharded by reference bin).
"""

__version__ = "0.1.0"

import os as _os


def _tune_host_alloc() -> None:
    """Disable numpy's madvise(MADV_HUGEPAGE) on large allocations.

    On kernels with THP defrag=madvise, numpy's default hugepage hint
    makes every first-touch fault do synchronous compaction — measured
    here at ~0.6 ms/page, i.e. ~10 s to fill a 67 MB array (the 4^12
    k-mer lookup tables).  Plain 4K faults fill the same array in
    ~0.03 s.  Opt back into numpy's default with
    SALT_TPU_MADVISE_HUGEPAGE=1.
    """
    if _os.environ.get("SALT_TPU_MADVISE_HUGEPAGE") == "1":
        return
    _os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
    try:  # numpy may already be imported (env preload hooks): flip live
        import numpy as _np

        _mod = getattr(_np, "_core", None) or _np.core
        _mod.multiarray._set_madvise_hugepage(False)
    except Exception:  # pragma: no cover - best effort
        pass


_tune_host_alloc()
