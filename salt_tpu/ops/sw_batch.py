"""Batched score-only affine Smith-Waterman for candidate pre-filtering.

The PE mate-rescue and -X 1 extension paths need the striped-SW score
of (read, reference-window) pairs to DECIDE (accept >= thres_score,
pick the best locus); the full result (begin/end, score2, cigar) is
only needed for the accepted winner (salt_tpu/ops/ssw.py computes it
bit-faithfully to the vendored SSW, Align_src/ssw.c).

This module scores thousands of candidates per device call with the
textbook affine-gap SW recurrence.  SSW's striped pass computes E from
the pre-lazy-F H (ssw.c:227-230), so its scores can only be LOWER than
the textbook score; `textbook < threshold  =>  ssw < threshold` makes
this a sound reject filter, and in practice the scores are equal (the
fuzz test asserts both relations).  Accepted candidates are re-run
through the exact host SSW, so observable behavior is byte-identical.

Column scan with the vertical-gap prefix-max trick: within a column,
F(i) = max_{k<i} (H_nof(k) - gapO - (i-1-k) * gapE) is an associative
scan of g(x, y) = max(x - gapE, y), and computing F from the
F-uncorrected H is exact for gapO > 0 (re-opening a gap from a
gap-extended cell is strictly worse than extending the existing gap).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NEG = jnp.int32(-(2**20))


def _score_snp(ref_nib, read_onehot, match=1, mismatch=-3):
    """score_mat2 semantics (alnpe.c:58-73): one-hot AND nonzero on
    rows/cols 1,2,4,8 scores +1, everything else (incl. 0/15 codes) -3.
    read one-hot 15 (N) only matches ref nibble rows where the matrix
    has 1 — rows 1,2,4,8; but mat2[r][15]=1 only for r in {1,2,4,8}."""
    is_pow2 = (ref_nib & (ref_nib - 1)) == 0
    r_ok = is_pow2 & (ref_nib != 0)
    # column one-hot: mat2 row r (in {1,2,4,8}) has +1 where col & r != 0
    hit = r_ok & ((ref_nib & read_onehot) != 0)
    return jnp.where(hit, jnp.int32(match), jnp.int32(mismatch))


def _score_plain(ref_code, read_code, match=1, mismatch=-3, n_pen=-1):
    """score_mat semantics (alnpe.c:52-56): 5x5, N row/col -1."""
    any_n = (ref_code >= 4) | (read_code >= 4)
    eq = ref_code == read_code
    return jnp.where(
        any_n, jnp.int32(n_pen),
        jnp.where(eq, jnp.int32(match), jnp.int32(mismatch)),
    )


@partial(jax.jit, static_argnames=("snp_mode", "gap_open", "gap_extend"))
def sw_score_batch(
    refs: jnp.ndarray,      # (B, W) int32: mixref nibbles (snp) or codes
    reads: jnp.ndarray,     # (B, L) int32: one-hot (snp) or codes (plain)
    ref_len: jnp.ndarray,   # (B,) int32 true window lengths (<= W)
    snp_mode: bool = True,
    gap_open: int = 3,
    gap_extend: int = 1,
) -> jnp.ndarray:
    """Returns (B,) int32 best local alignment score (0 if none)."""
    B, W = refs.shape
    L = reads.shape[1]
    go = jnp.int32(gap_open)
    ge = jnp.int32(gap_extend)
    irow = jnp.arange(L, dtype=jnp.int32)
    jcol = jnp.arange(W, dtype=jnp.int32)
    valid_col = jcol[None, :] < ref_len[:, None]          # (B, W)

    def col_step(carry, inp):
        h_prev, e_prev, best = carry                      # (B, L) each
        ref_c, vcol = inp                                 # (B,), (B,)
        if snp_mode:
            s = _score_snp(ref_c[:, None], reads)         # (B, L)
        else:
            s = _score_plain(ref_c[:, None], reads)
        e = jnp.maximum(e_prev - ge, h_prev - go)
        h_diag = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), h_prev[:, :-1]], axis=1
        )
        h_nof = jnp.maximum(jnp.maximum(h_diag + s, e), 0)
        # F(i) = max_{k<i} h_nof(k) - go - (i-1-k)*ge, computed as a
        # position-adjusted running max: (fsrc(k) + k*ge) is monotone-
        # comparable, F(i) = runmax(i) - i*ge (max is associative; the
        # per-distance ge decay folds into the +k*ge / -i*ge shears)
        fsrc = jnp.concatenate(
            [jnp.full((B, 1), NEG), (h_nof - go + ge)[:, :-1]], axis=1
        )
        key = fsrc + irow[None, :] * ge
        runmax = jax.lax.associative_scan(jnp.maximum, key, axis=1)
        f = runmax - (irow[None, :] + 1) * ge
        h = jnp.maximum(h_nof, f)
        h = jnp.where(vcol[:, None], h, 0)
        e = jnp.where(vcol[:, None], e, 0)
        best = jnp.maximum(best, jnp.max(h, axis=1))
        return (h, e, best), None

    h0 = jnp.zeros((B, L), jnp.int32)
    e0 = jnp.zeros((B, L), jnp.int32)
    b0 = jnp.zeros((B,), jnp.int32)
    (_, _, best), _ = jax.lax.scan(
        col_step, (h0, e0, b0),
        (refs.T.astype(jnp.int32), valid_col.T),
    )
    return best


def sw_score_rows(refs: np.ndarray, reads: np.ndarray, lens: np.ndarray,
                  snp_mode: bool, gap_open: int = 3,
                  gap_extend: int = 1) -> np.ndarray:
    """sw_score_batch over host arrays, with the row count padded to a
    power of two (at least 64) so a stream of variable-size candidate
    batches compiles a handful of programs, not one per size.  Padding
    rows have ref_len 0 and score 0."""
    n = refs.shape[0]
    rows = max(64, 1 << max(n - 1, 0).bit_length())
    pad = ((0, rows - n), (0, 0))
    sc = sw_score_batch(
        jnp.asarray(np.pad(refs, pad)), jnp.asarray(np.pad(reads, pad)),
        jnp.asarray(np.pad(lens, (0, rows - n))), snp_mode=snp_mode,
        gap_open=gap_open, gap_extend=gap_extend)
    return np.asarray(sc)[:n]


def sw_score_numpy(ref: np.ndarray, read: np.ndarray, snp_mode: bool,
                   gap_open: int = 3, gap_extend: int = 1) -> int:
    """Plain O(W*L) textbook affine SW for testing (single pair)."""
    W, L = len(ref), len(read)
    H = np.zeros((W + 1, L + 1), np.int32)
    E = np.full((W + 1, L + 1), -10**6, np.int32)
    F = np.full((W + 1, L + 1), -10**6, np.int32)
    best = 0
    for j in range(1, W + 1):
        for i in range(1, L + 1):
            r, q = int(ref[j - 1]), int(read[i - 1])
            if snp_mode:
                pw2 = r != 0 and (r & (r - 1)) == 0
                s = 1 if (pw2 and (r & q) != 0) else -3
            else:
                s = -1 if (r >= 4 or q >= 4) else (1 if r == q else -3)
            E[j][i] = max(E[j - 1][i] - gap_extend, H[j - 1][i] - gap_open)
            F[j][i] = max(F[j][i - 1] - gap_extend, H[j][i - 1] - gap_open)
            H[j][i] = max(0, H[j - 1][i - 1] + s, E[j][i], F[j][i])
            best = max(best, int(H[j][i]))
    return best
