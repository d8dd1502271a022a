"""The training loss of the three backbones and its gradients in the port
against jax.grad of the JAX package's cfm_loss, on the CPU, fp32: relative
1e-4 (sums in another order; the JAX draws are handed over, dropout off).
Tiny models (dim 64, depth 2, 4 heads x 16) from the JAX package's inits,
their AdaLN-zero layers re-drawn.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import BACKBONE_ARCH, jax_draws, rel_err, t
from _torch_port_util import backbone_pair as pair
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.train.checkpoint import flatten_tree
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree as pflatten
from korean_f5_tts_tpu_torch.train.checkpoint import params_to_jax
from korean_f5_tts_tpu_torch.train.checkpoint import unflatten_tree as punflatten

BACKBONES = sorted(BACKBONE_ARCH)


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # the CPU takes the plain versions


@pytest.mark.parametrize("backbone", BACKBONES)
def test_cfm_loss_and_gradients_match_jax(backbone):
    jcfg, pcfg, jp, pp, flat = pair(backbone, seed=2)
    rng = np.random.default_rng(5)
    b, n = 2, 96
    lens = np.asarray([96, 71], np.int32)
    mel = rng.standard_normal((b, n, 100)).astype(np.float32)
    mel[1, lens[1]:] = 0.0
    text = np.full((b, 30), -1, np.int32)
    text[0, :25] = rng.integers(0, 49, 25)
    text[1, :11] = rng.integers(0, 49, 11)
    key = jax.random.PRNGKey(11)

    def jloss(p):
        return jcfm.cfm_loss(p, jcfg, jnp.asarray(mel), jnp.asarray(text), jnp.asarray(lens),
                             key, use_dropout=False)[0]

    loss_j, grads_j = jax.value_and_grad(jloss)(jp)
    draws = jax_draws(key, (b, n, 100), lens)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in pflatten(pp).items()}
    loss_p, _, _ = pcfm.cfm_loss_from_draws(punflatten(leaves), pcfg, t(mel), t(text),
                                            t(lens), draws)
    grads = torch.autograd.grad(loss_p, list(leaves.values()), allow_unused=True)
    got = params_to_jax(punflatten({k: torch.zeros_like(v) if g is None else g
                                    for (k, v), g in zip(leaves.items(), grads)}))
    want = {k: np.asarray(v) for k, v in flatten_tree(grads_j).items()}
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-5)
    assert got.keys() == want.keys() == flat.keys()
    assert rel_err(np.concatenate([got[k].ravel() for k in want]),
                   np.concatenate([want[k].ravel() for k in want])) < 1e-4
