"""Batched score-only SW (ops/sw_batch.py) vs the bit-faithful SSW and
a naive numpy oracle."""

import numpy as np
import pytest

from salt_tpu.ops.ssw import SCORE_MAT5, SCORE_MAT16, ssw_align_py
from salt_tpu.ops.sw_batch import (sw_score_batch, sw_score_numpy,
                                   sw_score_rows)

ONEHOT = np.array([1, 2, 4, 8, 15], dtype=np.int8)


def _rand_case(rng, snp, L=40, W=90):
    read = rng.integers(0, 4, L).astype(np.int8)
    # window contains a mutated copy of the read so alignments are real
    ref_codes = rng.integers(0, 4, W).astype(np.int8)
    at = int(rng.integers(0, W - L))
    mut = read.copy()
    nm = int(rng.integers(0, 6))
    for _ in range(nm):
        p = int(rng.integers(0, L))
        mut[p] = (mut[p] + 1) % 4
    # occasional indel
    if rng.random() < 0.5:
        p = int(rng.integers(1, L - 1))
        mut = np.concatenate([mut[:p], mut[p + 1 :], [0]]).astype(np.int8)
    ref_codes[at : at + L] = mut[:L]
    if snp:
        ref = ONEHOT[ref_codes].astype(np.int8)
        # sprinkle SNP alleles (multi-bit nibbles)
        for _ in range(4):
            p = int(rng.integers(0, W))
            ref[p] |= 1 << int(rng.integers(0, 4))
        query = ONEHOT[read].astype(np.int8)
        return ref, query, read
    return ref_codes, ONEHOT[read].astype(np.int8), read


@pytest.mark.parametrize("snp", [True, False])
def test_matches_naive_oracle(snp):
    rng = np.random.default_rng(0 if snp else 1)
    B = 12
    cases = [_rand_case(rng, snp) for _ in range(B)]
    W = max(len(c[0]) for c in cases)
    L = len(cases[0][2])
    refs = np.zeros((B, W), np.int32)
    reads = np.zeros((B, L), np.int32)
    lens = np.zeros(B, np.int32)
    for i, (ref, onehot, read) in enumerate(cases):
        refs[i, : len(ref)] = ref
        reads[i] = onehot if snp else read
        lens[i] = len(ref)
    got = np.asarray(sw_score_batch(refs, reads, lens, snp_mode=snp))
    for i, (ref, onehot, read) in enumerate(cases):
        want = sw_score_numpy(ref, onehot if snp else read, snp)
        assert got[i] == want, (i, got[i], want)


@pytest.mark.parametrize("snp", [True, False])
def test_matches_ssw_scores(snp):
    """textbook score == SSW score on realistic cases, and always >=
    (SSW's stale-E pass can only lose score)."""
    rng = np.random.default_rng(42 if snp else 43)
    n_eq = 0
    B = 16
    cases = [_rand_case(rng, snp) for _ in range(B)]
    W = max(len(c[0]) for c in cases)
    L = len(cases[0][2])
    refs = np.zeros((B, W), np.int32)
    reads = np.zeros((B, L), np.int32)
    lens = np.zeros(B, np.int32)
    for i, (ref, onehot, read) in enumerate(cases):
        refs[i, : len(ref)] = ref
        reads[i] = onehot if snp else read
        lens[i] = len(ref)
    got = np.asarray(sw_score_batch(refs, reads, lens, snp_mode=snp))
    for i, (ref, onehot, read) in enumerate(cases):
        if snp:
            r = ssw_align_py(onehot.astype(np.int8), ref.astype(np.int8),
                             SCORE_MAT16, 3, 1, len(read) // 2,
                             want_cigar=False)
        else:
            r = ssw_align_py(read.astype(np.int8), ref.astype(np.int8),
                             SCORE_MAT5, 3, 1, len(read) // 2,
                             want_cigar=False)
        assert got[i] >= r.score1
        n_eq += int(got[i] == r.score1)
    assert n_eq == B  # equal on every realistic case


def test_padding_is_inert():
    rng = np.random.default_rng(7)
    ref, onehot, read = _rand_case(rng, True)
    refs = np.zeros((1, len(ref) + 64), np.int32)
    refs[0, : len(ref)] = ref
    lens = np.array([len(ref)], np.int32)
    a = np.asarray(sw_score_batch(refs, onehot[None].astype(np.int32), lens))
    b = sw_score_numpy(ref, onehot, True)
    assert a[0] == b



# (read length, window width): the -X 1 extension scores L+5-wide
# windows (engine._sw_extend_prefilter); PE rescue scores the insert
# window bucketed to 128 columns (pe_engine._device_sw_scores, 401
# columns at -a 250 -b 550 and 100bp reads).  "wide" reads exceed 128.
@pytest.mark.parametrize("snp", [True, False], ids=["snp", "plain"])
@pytest.mark.parametrize("L,W", [(100, 105), (150, 155), (104, 512),
                                 (152, 640)],
                         ids=["x1", "x1_wide", "rescue", "rescue_wide"])
def test_production_widths_match_naive(snp, L, W):
    rng = np.random.default_rng(L * 1000 + W + snp)
    B = 3
    refs = np.zeros((B, W), np.int32)
    reads = np.zeros((B, L), np.int32)
    lens = rng.integers(W // 2, W + 1, B).astype(np.int32)
    lens[0] = W
    for i in range(B):
        codes = rng.integers(0, 4, lens[i])
        at = int(rng.integers(0, lens[i] - L // 2))
        read = rng.integers(0, 4, L)
        n = min(L, lens[i] - at)
        read[:n] = codes[at : at + n]           # a real (partial) hit
        read[rng.random(L) < 0.05] = 3          # and some mismatches
        if snp:
            ref = ONEHOT[codes].astype(np.int32)
            ref[rng.random(lens[i]) < 0.03] |= 1 << int(rng.integers(0, 4))
            refs[i, : lens[i]] = ref
            reads[i] = ONEHOT[read]
        else:
            codes[rng.random(lens[i]) < 0.01] = 4  # N bases
            refs[i, : lens[i]] = codes
            reads[i] = read
    got = np.asarray(sw_score_batch(refs, reads, lens, snp_mode=snp))
    for i in range(B):
        want = sw_score_numpy(refs[i, : lens[i]], reads[i], snp)
        assert got[i] == want, (i, got[i], want)


def test_rows_padding_is_inert():
    """sw_score_rows pads the candidate count to a power of two (>= 64);
    the padding must not change any real row's score."""
    rng = np.random.default_rng(11)
    B, L, W = 70, 24, 40
    refs = (1 << rng.integers(0, 4, (B, W))).astype(np.int32)
    reads = (1 << rng.integers(0, 4, (B, L))).astype(np.int32)
    lens = rng.integers(L, W + 1, B).astype(np.int32)
    refs[np.arange(W)[None, :] >= lens[:, None]] = 0
    got = sw_score_rows(refs, reads, lens, snp_mode=True)
    assert got.shape == (B,)
    want = np.asarray(sw_score_batch(refs, reads, lens, snp_mode=True))
    assert (got == want).all()
    assert (sw_score_rows(refs[:5], reads[:5], lens[:5], snp_mode=True)
            == want[:5]).all()
