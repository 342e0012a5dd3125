"""Kernel B1's plain version (styletts2_tpu_torch/ops/vocoder_kernel.py) and
the port's AdaINResBlock1 against the JAX package.

The CUDA kernel itself is checked against the plain version on the card by
chip_smoke.py; here the plain version is held against the Pallas kernel
run in interpret mode (as tests/test_vocoder_pallas.py runs it) and the
block against blocks.adain_res_block1_apply's XLA path. Inputs come from
numpy seeds and pass between the frameworks as numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.nn import blocks as JB
from styletts2_tpu.ops import vocoder_pallas as VP
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.nn import blocks as TB
from styletts2_tpu_torch.ops import vocoder_kernel as VK

torch.set_num_threads(2)

# f32: both sides are true-f32 with different summation orders over
# C*k <= 704 products of O(1) terms. bf16: both round z and the output to
# bf16 at the same points; an f32 difference of a few ulps can flip one
# rounding, i.e. one bf16 step (2^-8 relative) of the largest |output|.
TOL = {"float32": dict(atol=2e-4, rtol=1e-4),
       "bfloat16": dict(atol=2.0 ** -8 * 8.0, rtol=2.0 ** -8)}


def _inputs(c, k, t, seed, b=2):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((b, t, c)).astype(np.float32),
        res=rng.standard_normal((b, t, c)).astype(np.float32),
        scale=(rng.standard_normal((b, c)) * 0.5 + 1.0).astype(np.float32),
        shift=(rng.standard_normal((b, c)) * 0.1).astype(np.float32),
        alpha=(np.abs(rng.standard_normal(c)) + 0.5).astype(np.float32),
        w=(rng.standard_normal((c, c, k)) * 0.05).astype(np.float32),
        bias=(rng.standard_normal(c) * 0.01).astype(np.float32),
        n_valid=np.array([t, t - 37], np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "res_stats"])
@pytest.mark.parametrize("c,k,d", [(32, 3, 1), (32, 7, 3), (32, 11, 5),
                                   (64, 3, 5), (64, 7, 1), (64, 11, 3)])
def test_plain_matches_pallas_interpret(c, k, d, fused, dtype):
    t = 160
    v = _inputs(c, k, t, seed=c + k + d)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = jnp.asarray(v["x"]).astype(jdt)
    jres = jnp.asarray(v["res"]).astype(jdt) if fused else None
    want = VP.fused_ada_snake_conv(
        jx, jnp.asarray(v["scale"]), jnp.asarray(v["shift"]),
        jnp.asarray(v["alpha"]), jnp.asarray(v["w"]), jnp.asarray(v["bias"]),
        d, jnp.asarray(v["n_valid"]), interpret=True, residual=jres,
        out_stats=fused)

    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)
    tres = (torch.tensor(np.asarray(jres.astype(jnp.float32))).to(tdt)
            if fused else None)
    w_kio = torch.from_numpy(v["w"]).permute(2, 1, 0).to(tdt).contiguous()
    got = VK.ada_snake_conv(
        tx, torch.from_numpy(v["scale"]), torch.from_numpy(v["shift"]),
        torch.from_numpy(v["alpha"]), w_kio, torch.from_numpy(v["bias"]), d,
        torch.from_numpy(v["n_valid"]), residual=tres, out_stats=fused)
    if fused:
        (want, want_st), (got, got_st) = want, got
        # the tile layouts differ: compare per-(B, C) totals; each total
        # sums <= 160 outputs that may each differ by one bf16 step
        tot = np.asarray(want_st).sum(axis=1)
        np.testing.assert_allclose(got_st.numpy(), tot,
                                   atol=160 * TOL[dtype]["atol"],
                                   rtol=10 * TOL[dtype]["rtol"])
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def test_wrapper_rejects_bad_operands():
    v = _inputs(32, 3, 40, seed=1, b=1)
    x = torch.from_numpy(v["x"])
    args = [torch.from_numpy(v["scale"]), torch.from_numpy(v["shift"]),
            torch.from_numpy(v["alpha"])]
    w_kio = torch.from_numpy(v["w"]).permute(2, 1, 0).contiguous()
    bias = torch.from_numpy(v["bias"])
    nv = torch.tensor([30], dtype=torch.int32)
    with pytest.raises(ValueError, match="w must be"):
        VK.ada_snake_conv(x, *args, w_kio.to(torch.bfloat16), bias, 1, nv)
    with pytest.raises(ValueError, match="n_valid"):
        VK.ada_snake_conv(x, *args, w_kio, bias, 1, nv.long())
    assert VK.ada_snake_conv.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("c,k,dil", [(32, 3, (1, 3, 5)), (64, 7, (1, 3))])
def test_block_matches_jax_xla_path(c, k, dil):
    """AdaINResBlock1 (plain B1 on CPU, f32: two-pass stats, separate
    residual add) == blocks.adain_res_block1_apply with (mask, n_valid),
    which takes the unfolded XLA path on CPU."""
    rng = np.random.default_rng(3)
    b, t, sd = 2, 120, 16
    tree = jax.tree.map(np.asarray, JB.adain_res_block1_init(
        jax.random.PRNGKey(c + k), c, k, dil, sd))
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    s = rng.standard_normal((b, sd)).astype(np.float32)
    n_valid = np.array([t, t - 29], np.int32)
    mask = np.arange(t)[None, :] < n_valid[:, None]

    from styletts2_tpu.convert import fuse_weight_norm
    want = JB.adain_res_block1_apply(
        fuse_weight_norm({"m": tree})["m"], jnp.asarray(x), jnp.asarray(s),
        k, dil, jnp.asarray(mask), n_valid=jnp.asarray(n_valid))

    blk = TB.AdaINResBlock1(c, k, dil, sd)
    W.load_param_tree({"blk": blk}, {"blk": tree})
    blk.prepack(torch.float32)
    with torch.no_grad():  # kernel B1's path is inference only
        got = blk(torch.from_numpy(x), torch.from_numpy(s),
                  torch.from_numpy(mask), torch.from_numpy(n_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-4, rtol=1e-3)


def test_block_bf16_stats_path_tracks_f32():
    """The bf16 block (residual fused into conv2, next AdaIN from the
    kernel's one-pass stats) stays within bf16 noise of the f32 block."""
    rng = np.random.default_rng(5)
    b, t, c, sd = 1, 200, 32, 16
    tree = jax.tree.map(np.asarray, JB.adain_res_block1_init(
        jax.random.PRNGKey(9), c, 3, (1, 3, 5), sd))
    blk = TB.AdaINResBlock1(c, 3, (1, 3, 5), sd)
    W.load_param_tree({"blk": blk}, {"blk": tree})
    x = torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((b, sd)).astype(np.float32))
    nv = torch.tensor([171], dtype=torch.int32)
    mask = torch.arange(t)[None, :] < nv[:, None]
    with torch.no_grad():
        blk.prepack(torch.float32)
        ref = blk(x, s, mask, nv)
        blk.prepack(torch.bfloat16)
        got = blk(x.to(torch.bfloat16), s, mask, nv).float()
    rel = (torch.linalg.norm(got - ref) / torch.linalg.norm(ref)).item()
    assert rel < 0.02, rel  # bf16 activations: ~2^-8 per rounding
