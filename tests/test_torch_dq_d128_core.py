"""Kernels 11 and 12 at head dim 128 in bf16 on the attention backward core's
D = 128 dq form (csrc/flash_prefix_bwd_core_d128.cu: attn_dq_d128_wgmma_kernel),
mirrored in torch on the CPU and held against the JAX package's Pallas
kernels _flash_prefix_dq_lsein and _flash_prefix_dq at d = 128 in interpret
mode; and the plain versions the card holds the kernel to, against the same
interpret kernels at the same edges.

The mirror follows the kernel's schedule: blocks of 128 query rows (rows past
n zero, as TMA fills them, with D 0 and, for 11, lse +inf, so P = 0; never
stored), 64-key K/V tiles, ceil(kv_len / 64) of them, S and dP in fp32, dS
rounded to bf16 for dq += dS.K, fp32 accumulation; kernel 12 keeps its
running max per 64-key tile (the TPU kernel per chunk) and multiplies the
accumulator by alpha only after tile i - 1's product has landed
(tests/test_torch_flash_train_core.py:kernel12_schedule at tile 64). The
other order is the race the kernel avoids: as a control it must miss the
bound.

Cases: n 1, 65, 129 and 300 (one to three 128-row blocks; 300 puts an [H, n]
row of lse and D at no 16-byte boundary), kv_len 0, 1, 63-65, 127-129 and n
(the 64-key tiles' edges), four folded heads a case, some with the keys past
kv_len along q's mean direction at +-1e4 (they would win every max unless
masked first). The JAX side is zero-padded to 384 rows, a multiple of 128 as
its kernels need (tests/test_torch_flash_train_core.py pads to the next
one; one padded length here, so each JAX kernel compiles once for the
file): the padded keys lie past every kv_len, the padded queries get lse 0
and D 0 and their rows are dropped. Each case's JAX outputs are computed
once and shared by the tests that read them.

Bounds: the mirror's dq within 1e-2 relative L2 of the TPU kernel's on fp32
operands of bf16 values (bf16 dS and the per-tile max on the mirror's side),
12's lse within 1e-5; the control is checked where a head
walks two full tiles or more; a head with kv_len 0 is held to zero dq
and lse 0 (the TPU kernel's mask is finite, so at kv_len 0 its 12 averages
every key: such heads are left out of its comparison); at n = 1 dq is
identically zero (dS = P (dP - D) = 0 for the one key) and is held to |dq| <=
1e-5. The plain versions: 11 on bf16 operands against the TPU kernel on
bf16 operands within 1e-2 relative L2, as the mirror (at d = 128 that
kernel's bf16 roundings of q * scale, dS and dq put a few of 153,600
elements past the 4 bf16 ulps at the output's scale that
tests/test_torch_flash_train_core.py holds at d = 64, and 6e-3 to 8e-3 of
relative L2 between the two), 12 on fp32 operands within 1e-4 (dq) and 1e-5
(lse) elementwise, as there.
"""

import functools
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from _torch_port_util import rel_err, t
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.ops import flash_prefix as fp
from test_torch_flash_train_core import kernel12_schedule

D = 128
SCALE = D ** -0.5
ROWS = 128   # query rows a block of the kernel
TILE = 64    # keys a K/V tile
N_PAD = 384  # rows of the JAX side (a multiple of 128 past every n below)

# (n, kv_lens, keys past kv_len at +-1e4)
CASES = [
    (1, [1, 0, 1, 1], False),
    (65, [0, 1, 63, 65], False),
    (65, [64, 65, 1, 63], True),
    (129, [0, 127, 128, 129], False),
    (129, [63, 64, 65, 129], True),
    (300, [300, 1, 0, 128], False),
    (300, [300, 63, 64, 65], True),
    (300, [127, 128, 129, 300], True),
]
IDS = [f"n{n}-kv{'_'.join(map(str, lens))}{'-past' if p else ''}" for n, lens, p in CASES]


@pytest.fixture(autouse=True)
def _interpret_and_counts():
    old = jfp._INTERPRET
    jfp._INTERPRET = True
    reset_launch_counts()
    yield
    # on the CPU every wrapper takes its plain version: nothing launches
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    jfp._INTERPRET = old


def _inputs(n, lens, past):
    """q, k, v, dO [H, n, 128] fp32 holding bf16 values (seeded numpy), kv_lens,
    and the plain forward's lse and D = rowsum(dO * o) on them."""
    H = len(lens)
    rng = np.random.default_rng(128 * n + H + past)
    x = [rng.standard_normal((H, n, D)).astype(np.float32) for _ in range(4)]
    if past:
        for h, length in enumerate(lens):
            x[1][h, length:] = 1e4 * np.sign(x[0][h].mean(0))
    q, k, v, do = (t(a).to(torch.bfloat16).float() for a in x)
    kv = torch.tensor(lens, dtype=torch.int32)
    o, lse = fp.prefix_attention_lse_reference(q, k, v, kv)
    o[kv == 0] = 0  # no valid key: zeros, as the kernels give (not the plain uniform mean)
    return q, k, v, do, kv, lse, (do * o).sum(-1)


def _jax(n, *arrays):
    """Torch [H, n, ...] as JAX arrays zero-padded to N_PAD rows."""
    return [jnp.asarray(np.pad(a.numpy(), ((0, 0), (0, N_PAD - n)) + ((0, 0),) * (a.dim() - 2)))
            for a in arrays]


@functools.lru_cache(maxsize=None)
def _tpu_kernels(case: int):
    """The TPU kernels on case `case`'s inputs, in interpret mode, cast=True
    (the training path's): 11 on bf16 operands and on fp32 operands of the
    same bf16 values -> dq, dq; 12 on the fp32 ones (its default 512-key
    chunk) -> (dq, lse); the first n rows, fp32 numpy."""
    n, lens, past = CASES[case]
    q, k, v, do, _, lse, dvec = _inputs(n, lens, past)
    jq, jk, jv, jdo, jd, jl = _jax(n, q, k, v, do, dvec, lse)
    kv = jnp.asarray(lens)
    old, jfp._INTERPRET = jfp._INTERPRET, True
    try:
        dq11 = [jfp._flash_prefix_dq_lsein(*(a.astype(dt) for a in (jq, jk, jv, jdo)),
                                           jd[..., None], jl[..., None], kv, SCALE, bq=128,
                                           ck=128, cast=True)
                for dt in (jnp.bfloat16, jnp.float32)]
        dq12, lse12 = jfp._flash_prefix_dq(jq, jk, jv, jdo, jd[..., None], kv, SCALE, bq=128,
                                           cast=True)
    finally:
        jfp._INTERPRET = old
    return (*(np.asarray(a.astype(jnp.float32))[:, :n] for a in dq11), np.asarray(dq12)[:, :n],
            np.asarray(lse12)[:, :n, 0])


def kernel11_schedule(q, k, v, do, dvec, lse, kv_lens, tile: int = TILE):
    """Kernel 11 at d = 128 (attn_dq_d128_wgmma_kernel<false>) in torch on one
    block of query rows: ceil(kv_len / tile) key tiles, p = exp2(S *
    scale_log2 - lse) with keys at or past kv_len at -inf, dS = p (dP - D)
    rounded to bf16, dq += dS.K in fp32, dq * 1/sqrt(d) at the end."""
    H, m_rows, d = q.shape
    n = k.shape[1]
    scale_log2 = jfp.LOG2E / math.sqrt(d)
    dq = torch.zeros((H, m_rows, d))
    for h in range(H):
        kv_len = min(int(kv_lens[h]), n)
        n_tiles = -(-kv_len // tile)
        pad = max(n_tiles * tile - n, 0)
        kh, vh = (F.pad(x[h], (0, 0, 0, pad)) for x in (k, v))
        for i in range(n_tiles):
            kt, vt = kh[i * tile:(i + 1) * tile], vh[i * tile:(i + 1) * tile]
            x = (q[h] @ kt.T) * scale_log2 - lse[h][:, None]
            x = x.masked_fill(torch.arange(i * tile, (i + 1) * tile)[None, :] >= kv_len, -math.inf)
            p = torch.exp2(x)
            ds = (p * (do[h] @ vt.T - dvec[h][:, None])).to(torch.bfloat16).float()
            dq[h] += ds @ kt
    return dq / math.sqrt(d)


def dq_d128_schedule(q, k, v, do, dvec, kv_lens, lse=None, after_product: bool = True):
    """The D = 128 dq core in torch, block by block of 128 query rows: kernel
    11 (lse given: dq) or 12 (lse None: (dq, lse)). Rows past n are zero with
    D 0 (11: lse +inf) and dropped."""
    n = q.shape[1]
    pad = -(-n // ROWS) * ROWS - n
    qp, dop = (F.pad(x, (0, 0, 0, pad)) for x in (q, do))
    dvp = F.pad(dvec, (0, pad))
    lsep = None if lse is None else F.pad(lse, (0, pad), value=math.inf)
    dq, lse_out = [], []
    for r0 in range(0, n + pad, ROWS):
        rows = slice(r0, r0 + ROWS)
        if lse is None:
            a, b = kernel12_schedule(qp[:, rows], k, v, dop[:, rows], dvp[:, rows], kv_lens,
                                     after_product=after_product, tile=TILE)
            lse_out.append(b)
        else:
            a = kernel11_schedule(qp[:, rows], k, v, dop[:, rows], dvp[:, rows], lsep[:, rows],
                                  kv_lens)
        dq.append(a)
    dq = torch.cat(dq, dim=1)[:, :n]
    if lse is not None:
        return dq
    return dq, torch.cat(lse_out, dim=1)[:, :n]


def _hold_dq(got, want, lens, n):
    """got (the mirror's or a plain dq) against want on the heads with a valid
    key: |dq| <= 1e-5 at n = 1, else relative L2 within 1e-2."""
    live = np.asarray(lens) > 0
    got = np.asarray(got, np.float32)
    if n == 1:
        assert np.abs(got).max() <= 1e-5
        return None
    err = rel_err(got[live], np.asarray(want, np.float32)[live])
    assert err <= 1e-2, err
    return err


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_kernel_11_d128_schedule_against_the_tpu_kernel(case):
    """The mirror of kernel 11's D = 128 schedule against _kernel_dq_lsein at
    d = 128 on fp32 operands of bf16 values (the card's products see those
    values exactly; the JAX side then rounds nothing, and the mirror's bf16
    dS is the difference the bound covers)."""
    n, lens, past = CASES[case]
    q, k, v, do, kv, lse, dvec = _inputs(n, lens, past)
    dq = dq_d128_schedule(q, k, v, do, dvec, kv, lse=lse)
    dq_j = _tpu_kernels(case)[1]
    for h, length in enumerate(lens):
        if length == 0:
            assert not dq[h].any() and not dq_j[h].any()
    _hold_dq(dq.numpy(), dq_j, lens, n)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_kernel_12_d128_schedule_against_the_tpu_kernel(case):
    """The mirror of kernel 12's D = 128 schedule (running max per 64-key
    tile, the rescale after the previous tile's product) against _kernel_dq
    at d = 128 and its default chunk (fp32 operands of bf16 values): dq within
    1e-2, lse within 1e-5; the rescale before the product misses 1e-2 where a
    head walks two full tiles or more."""
    n, lens, past = CASES[case]
    q, k, v, do, kv, _, dvec = _inputs(n, lens, past)
    dq, lse = dq_d128_schedule(q, k, v, do, dvec, kv)
    _, _, dq_j, lse_j = _tpu_kernels(case)
    live = np.asarray(lens) > 0
    assert not dq[~live].any() and not lse[~live].any()
    lse, lse_j = lse[live].numpy(), lse_j[live]
    assert np.abs(lse - lse_j).max() <= 1e-5 * np.abs(lse_j).max()
    assert np.linalg.norm(lse - lse_j) <= 1e-5 * np.linalg.norm(lse_j)
    err = _hold_dq(dq.numpy(), dq_j, lens, n)
    if err is not None and max(lens) >= 2 * TILE:
        bad, _ = dq_d128_schedule(q, k, v, do, dvec, kv, after_product=False)
        err_bad = rel_err(bad[live].numpy(), dq_j[live])
        assert err_bad > 1e-2, err_bad


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_dq_plain_versions_at_head_dim_128_at_the_dq_core_edges(case):
    """The plain versions of 11 (bf16) and 12 (fp32) at d = 128 against the
    interpret kernels at the D = 128 dq core's edges."""
    n, lens, past = CASES[case]
    q, k, v, do, kv, lse, dvec = _inputs(n, lens, past)
    dq11_j, _, dq12_j, lse12_j = _tpu_kernels(case)
    dq11 = fp.flash_prefix_dq_lsein(*(x.to(torch.bfloat16) for x in (q, k, v, do)), dvec, lse,
                                    kv)
    assert dq11.dtype == torch.bfloat16
    _hold_dq(dq11.float().numpy(), dq11_j, lens, n)
    dq12, lse12 = fp.flash_prefix_dq(q, k, v, do, dvec, kv)
    live = np.asarray(lens) > 0
    assert not dq12[~live].any() and not lse12[~live].any()
    np.testing.assert_allclose(dq12[live].numpy(), dq12_j[live], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lse12[live].numpy(), lse12_j[live], rtol=1e-5, atol=1e-5)
