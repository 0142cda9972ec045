"""Fuzz the Landau-Vishkin reimplementations against the reference's
compiled computeEditDistance / computeEditDistanceWithCigar
(Align_src/LandauVishkin.c, built as a shared library by make_oracle.sh
or ad hoc: gcc -shared -fPIC -o liblvref.so LandauVishkin.c).
"""

import ctypes
import os

import numpy as np
import pytest

from salt_tpu.ops.lv import lv_cigar_host, lv_distance_batch, lv_distance_host

LIB = "/tmp/oracle/liblvref.so"

requires_lib = pytest.mark.skipif(
    not os.path.exists(LIB), reason="reference LV shared library missing"
)


@pytest.fixture(scope="module")
def ref():
    lib = ctypes.CDLL(LIB)
    lib.computeEditDistance.restype = ctypes.c_int
    lib.computeEditDistance.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.computeEditDistanceWithCigar.restype = ctypes.c_int
    lib.computeEditDistanceWithCigar.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    return lib


def _ref_distance(lib, text, pattern, k):
    # mimic ed_diff's calloc'd ((l+15)/8*8) buffers (editdistance.c:183-184)
    t = np.zeros((len(text) + 15) // 8 * 8, dtype=np.uint8)
    t[: len(text)] = text
    p = np.zeros((len(pattern) + 15) // 8 * 8, dtype=np.uint8)
    p[: len(pattern)] = pattern
    return lib.computeEditDistance(
        t.tobytes(), len(text), p.tobytes(), len(pattern), k
    )


def _ref_cigar(lib, text, pattern, k):
    t = np.zeros((len(text) + 15) // 8 * 8, dtype=np.uint8)
    t[: len(text)] = text
    p = np.zeros((len(pattern) + 15) // 8 * 8, dtype=np.uint8)
    p[: len(pattern)] = pattern
    buf = ctypes.create_string_buffer(256)
    e = lib.computeEditDistanceWithCigar(
        t.tobytes(), len(text), p.tobytes(), len(pattern), k, buf, 256, 1, 0
    )  # useM=1, COMPACT_CIGAR_STRING=0
    return e, buf.value.decode()


def _random_case(rng, L=100, snp_rate=0.05, err_rate=0.03, indel_rate=0.02):
    """Make a mixref-style text window + one-hot pattern pair."""
    TL = L + 4
    ref = rng.integers(0, 4, size=TL)
    text = (1 << ref).astype(np.uint8)
    # sprinkle SNP alleles into the text
    snp = rng.random(TL) < snp_rate
    text[snp] |= (1 << rng.integers(0, 4, size=snp.sum())).astype(np.uint8)
    # derive the pattern from ref with errors/indels
    pat = []
    i = 0
    while len(pat) < L and i < TL:
        r = rng.random()
        if r < indel_rate / 2:
            pat.append(int(rng.integers(0, 4)))  # insertion
        elif r < indel_rate:
            i += 1  # deletion
            continue
        else:
            b = int(ref[i])
            if rng.random() < err_rate:
                b = int(rng.integers(0, 4))
            pat.append(b)
            i += 1
    while len(pat) < L:
        pat.append(int(rng.integers(0, 4)))
    pattern = (1 << np.array(pat, dtype=np.uint8)).astype(np.uint8)
    return text, pattern


@requires_lib
def test_distance_host_fuzz(ref):
    rng = np.random.default_rng(2)
    for trial in range(300):
        text, pattern = _random_case(rng)
        k = int(rng.integers(1, 12))
        want = _ref_distance(ref, text, pattern, k)
        got = lv_distance_host(text, pattern, k)
        assert got == want, (trial, k)


@requires_lib
def test_cigar_host_fuzz(ref):
    rng = np.random.default_rng(3)
    for trial in range(300):
        text, pattern = _random_case(rng)
        k = int(rng.integers(1, 12))
        we, wc = _ref_cigar(ref, text, pattern, k)
        ge, gc = lv_cigar_host(text, pattern, k)
        assert ge == we, (trial, k)
        if we >= 0:
            assert gc == wc, (trial, k, gc, wc)


@requires_lib
def test_distance_device_fuzz(ref):
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    L = 100
    n = 64
    texts = np.zeros((n, L + 4), dtype=np.uint8)
    pats = np.zeros((n, L), dtype=np.uint8)
    for i in range(n):
        texts[i], pats[i] = _random_case(rng)
    k = 10
    # build a fake mixref = concatenated windows; pos = i*(L+4)
    mixref = jnp.asarray(texts.reshape(-1))
    pos = jnp.arange(n, dtype=jnp.int32) * (L + 4)
    active = jnp.ones(n, dtype=bool)
    # pattern codes: invert the one-hot (pure ACGT here)
    codes = np.log2(pats).astype(np.int32)
    got = np.asarray(
        lv_distance_batch(mixref, pos, active, jnp.asarray(codes), k)
    )
    for i in range(n):
        want = _ref_distance(ref, texts[i], pats[i], k)
        want = want if want >= 0 else 255
        assert got[i] == min(want, 255), (i, got[i], want)


@pytest.mark.parametrize("k", [3, 10, None], ids=["k3", "k10", "kL10"])
@pytest.mark.parametrize("L", [100, 150, 250])
def test_distance_device_matches_host(L, k):
    """The batched device LV equals the independent host
    computeEditDistance port, over the aligner's gapped-verify text
    window (L + 4) and the thresholds it uses (k = l_seq // 10)."""
    import jax.numpy as jnp

    k = L // 10 if k is None else k
    rng = np.random.default_rng(L * 100 + k)
    n = 24
    texts = np.zeros((n, L + 4), dtype=np.uint8)
    pats = np.zeros((n, L), dtype=np.uint8)
    for i in range(n):
        texts[i], pats[i] = _random_case(
            rng, L=L, err_rate=0.01 * (i % 5), indel_rate=0.01 * (i % 3))
    codes = np.log2(pats).astype(np.int32)
    active = np.ones(n, dtype=bool)
    active[-1] = False
    got = np.asarray(lv_distance_batch(
        jnp.asarray(texts.reshape(-1)),
        jnp.arange(n, dtype=jnp.int32) * (L + 4),
        jnp.asarray(active), jnp.asarray(codes), k))
    for i in range(n):
        want = lv_distance_host(texts[i], pats[i], k)
        want = 255 if want < 0 or not active[i] else want
        assert got[i] == want, (i, got[i], want)
