"""Device-side index construction equals the host-built tables.

Transfer-lean load path: the 12-mer tables, rank bit-planes and the
full locate tables (sa_cat) are built/derived on device from ~30x
smaller inputs.  These tests pin bit-equality against the host builders
on CPU.
"""

import numpy as np
import pytest

from salt_tpu.index.build import build_index_from_data
from salt_tpu.io.snp import SnpBlock


@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(11)
    seq = "".join(
        "ACGTN"[c] for c in rng.choice(5, 50000, p=[0.24, 0.24, 0.24, 0.24, 0.04])
    )
    pos = np.sort(rng.choice(50000, 250, replace=False)).astype(np.uint32)
    ref = np.frombuffer(seq.encode(), np.uint8)[pos]
    stype = []
    keep = []
    for p, c in zip(pos, ref):
        b = "ACGT".find(chr(c))
        if b < 0:
            continue
        stype.append((1 << b) | (1 << ((b + 1) % 4)) | (b << 4))
        keep.append(p)
    return build_index_from_data(
        [("c1", "t", seq)],
        [SnpBlock("c1", np.array(keep, np.uint32), np.array(stype, np.uint8))],
        l_seed=19,
    )


def test_device_lkt_tables_match_host(small_index):
    from salt_tpu.pipeline.device_index import to_device_index

    idx = small_index
    dix = to_device_index(idx)
    assert np.array_equal(np.asarray(dix.lkt), idx.lkt)
    sp = np.asarray(dix.r_lkt_sp)
    ep = np.asarray(dix.r_lkt_ep)
    live_d = sp <= ep
    live_h = idx.r_lkt_sp <= idx.r_lkt_ep
    assert np.array_equal(live_d, live_h)
    assert np.array_equal(sp[live_d], idx.r_lkt_sp[live_h])
    assert np.array_equal(ep[live_d], idx.r_lkt_ep[live_h])


def test_device_rank_planes_match_host(small_index):
    from salt_tpu.constants import C_SENTINEL, R_SENTINEL
    from salt_tpu.ops.rank import (build_rank_index, build_rank_index_device,
                                   build_rank_index_device_chunked)
    from salt_tpu.pipeline.device_index import _pack4
    import jax.numpy as jnp

    idx = small_index
    for syms, n_sym, cfreq, sent in (
        (idx.cbwt, 5, np.append(idx.c_l2, 0), C_SENTINEL),
        (idx.rbwt, 6, np.append(idx.r_cumfreq, 0), R_SENTINEL),
    ):
        host = build_rank_index(syms, n_sym, cfreq, sent)
        dev = build_rank_index_device(jnp.asarray(_pack4(syms)), len(syms),
                                      n_sym, cfreq)
        assert dev.n == host.n and dev.n_words == host.n_words
        assert np.array_equal(np.asarray(dev.bc), np.asarray(host.bc))
        # the whole-genome chunked builder must be bit-identical too
        # (an odd chunk size exercises the tail-chunk masking)
        from salt_tpu.ops.rank import _device_plane_chunked

        W = host.n_words
        chunked = np.concatenate([
            np.asarray(_device_plane_chunked(
                jnp.asarray(_pack4(syms)), c=c, n=len(syms), n_words=W,
                chunk=37))
            for c in range(n_sym)
        ])
        assert np.array_equal(chunked, np.asarray(host.bc))


def test_zero_snp_index_loads_all_modes(small_index):
    """Round-3 regression guard: an index with NO SNPs (empty
    sharp_bases, no '#' ranks) must load in full mode (derived sa_cat
    — the crash site, advisor r3 high) AND sampled mode."""
    from salt_tpu.pipeline.device_index import to_device_index

    idx0 = build_index_from_data(
        [("c1", "t", "".join(
            "ACGT"[c] for c in np.random.default_rng(3).choice(4, 20000)))],
        [],
        l_seed=19,
    )
    assert len(idx0.sharp_bases) == 0
    dix = to_device_index(idx0)
    dev = np.asarray(dix.sa_cat)
    n1c = len(idx0.csa)
    assert np.array_equal(dev[:n1c], idx0.csa)
    assert np.all(dev[n1c:] == 0xFFFFFFFF)
    dix2, sampled = to_device_index(idx0, sa_mode="sampled")
    # R block holds exactly the padded dummy slot
    assert sampled.samples_cat.shape[0] == sampled.c_n_samples + 1


def test_derived_sa_cat_matches_host(small_index):
    from salt_tpu.pipeline.device_index import to_device_index

    idx = small_index
    dix = to_device_index(idx)
    dev = np.asarray(dix.sa_cat)
    n1c = len(idx.csa)
    # C part exact everywhere (bounded text-sampled walk)
    assert np.array_equal(dev[:n1c], idx.csa)
    # R part exact on every rank holding a real coordinate; the only
    # allowed differences are UINT32_MAX sentinel-edge ranks, where the
    # derived value is >= 0x80000000 and fails the same range checks
    rc = idx.r_coord
    d = dev[n1c:]
    mism = np.nonzero(d != rc)[0]
    assert np.all(rc[mism] == 0xFFFFFFFF)
    assert np.all(d[mism] >= 0x80000000)
