"""The port's connectors vs the JAX package's (f32, CPU).

Parameters come from the JAX init (every leaf moved off its init by numpy
noise from a seed, so that biases, norm scales and queries matter) and
reach the port through ``convert.from_numpy_tree``; inputs are numpy from
a seed. The JAX side runs ``use_pallas="never"``, as its own CPU tests do.
The whole model, the engine, resume and the two repairs are in
``test_torch_connectors_model.py``. Tolerances: outputs atol/rtol 1e-4
(the module-parity tests' ``TOL``); gradients ||g - g_jax|| / ||g_jax||
<= 1e-4 per leaf (attention key biases, whose exact gradient is 0: max |g|
<= 1e-4 max |g| of the value bias, in both); lengths exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.core import config as jcfg
from avsr_tpu.models.connectors import get_connector as jget
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.models.connectors import upsample_to
from avsr_tpu_torch.models.connectors import get_connector as tget
from avsr_tpu_torch.ops import attention as tattn

from test_torch_models import TOL, np_tree
from test_torch_train import jax_paths, port_paths, rel_dist

torch.set_num_threads(1)

GRAD_TOL = 1e-4
SINGLE = ("deep", "conv", "attention", "adaptive")
DUAL = ("cross_modal", "qformer", "perceiver", "adapter")
# small connector widths: 32 = 8 heads of 4
MC = jcfg.ModelConfig(qformer_queries=4, perceiver_latents=6, adapter_dim=8)


def perturb(tree, seed):
    """Every leaf plus 0.05 * numpy noise from ``seed``."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(x.dtype), tree)


def run_both(name, dims, inputs, lens, *, use_kernel="never", seed=0):
    """Connector ``name`` in both packages on the same parameters and
    inputs: ((y, lengths, grads) of JAX, the same of the port), grads of
    sum(y * w) for a fixed random w, by key path."""
    jdef, tdef = jget(name), tget(name)
    params = perturb(np_tree(jdef.init(jax.random.key(seed), *dims, MC)), seed)
    args_j = [jnp.asarray(a) for a in (*inputs, *lens)]
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    y_j, l_j = jdef.apply(p_j, *args_j, use_pallas="never")
    w = np.random.default_rng(seed + 1).standard_normal(y_j.shape).astype(np.float32)
    g_j = jax.grad(lambda p: jnp.sum(jdef.apply(p, *args_j, use_pallas="never")[0] * w))(p_j)

    p_t = from_numpy_tree(params, "cpu")
    leaves = port_paths(p_t)
    for t in leaves.values():
        t.requires_grad_(True)
    args_t = [torch.from_numpy(np.asarray(a)) for a in (*inputs, *lens)]
    y_t, l_t = tdef.apply(p_t, *args_t, use_kernel=use_kernel)
    g_t = torch.autograd.grad((y_t * torch.from_numpy(w)).sum(), list(leaves.values()),
                              allow_unused=True)
    g_t = {k: (torch.zeros_like(v) if g is None else g)
           for (k, v), g in zip(leaves.items(), g_t)}
    return (y_j, l_j, jax_paths(g_j)), (y_t, l_t, g_t)


def assert_grads(g_t, g_j):
    """Per leaf ||g - g_jax|| <= GRAD_TOL ||g_jax||. An attention key
    bias adds the same q.b to every score of a row, which the softmax
    cancels: its exact gradient is 0, and both packages give rounding
    noise, held to GRAD_TOL of the same attention's value-bias gradient
    (max |g|) instead."""
    assert set(g_t) == set(g_j)
    for path, g in g_t.items():
        if path[-2:] == ("k", "b"):
            scale = float(np.abs(g_j[path[:-2] + ("v", "b")]).max())
            assert max(float(np.abs(g.numpy()).max()),
                       float(np.abs(g_j[path]).max())) <= GRAD_TOL * scale, path
        else:
            assert rel_dist(g.numpy(), g_j[path]) <= GRAD_TOL, path


def assert_same(res_j, res_t):
    (y_j, l_j, g_j), (y_t, l_t, g_t) = res_j, res_t
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    assert_grads(g_t, g_j)


def single_inputs(T=10, d_in=24, lens=(10, 7), seed=3):
    x = np.random.default_rng(seed).standard_normal((2, T, d_in)).astype(np.float32)
    return [x], [np.array(lens, np.int32)]


def dual_inputs(a_lens=(10, 7), v_lens=(4, 3), seed=4):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((2, 10, 24)).astype(np.float32)
    video = rng.standard_normal((2, 4, 16)).astype(np.float32)
    return [audio, video], [np.array(a_lens, np.int32), np.array(v_lens, np.int32)]


# ---------------------------------------------------------------------------
# the connectors alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SINGLE + DUAL)
def test_connector_matches_jax(name):
    """Output, lengths and parameter gradients of each connector, ragged
    lengths, the plain attention route."""
    if name in SINGLE:
        dims, (inputs, lens) = (24, 32), single_inputs()
    else:
        dims, (inputs, lens) = (24, 16, 32), dual_inputs()
    res_j, res_t = run_both(name, dims, inputs, lens)
    assert_same(res_j, res_t)
    if name in ("qformer", "perceiver"):
        n = MC.qformer_queries if name == "qformer" else MC.perceiver_latents
        assert res_t[0].shape == (2, n, 32) and res_t[1].tolist() == [n, n]
    else:
        assert res_t[1].tolist() == [10, 7]


@pytest.mark.parametrize("use_kernel", ["always", "never"])
@pytest.mark.parametrize("name,T,lens,out_lens", [
    ("attention", 300, (300, 211), [300, 211]),
    # T > 512: the stride-4 VALID conv, lengths max((len - 4) // 4 + 1, 1)
    ("adaptive", 1030, (1030, 777), [257, 194]),
    ("adaptive", 516, (516, 3), [129, 1]),
])
def test_attention_connectors_on_the_kernel_route(name, T, lens, out_lens, use_kernel):
    """The ``attention`` and ``adaptive`` connectors at a width whose heads
    the kernels take (512 = 8 heads of 64) over 256 rows or more: with
    ``use_kernel="always"`` the port runs the kernels' autograd Function
    (their plain versions on the CPU), and equals JAX's plain attention."""
    inputs, lens_in = single_inputs(T, lens=lens, seed=5)
    res_j, res_t = run_both(name, (24, 512), inputs, lens_in, use_kernel=use_kernel)
    assert_same(res_j, res_t)
    assert res_t[1].tolist() == out_lens


def test_adaptive_downsamples_only_past_512():
    """The static decision on the padded width: 512 rows keep their
    length, 513 rows are pooled by 4."""
    tdef = tget("adaptive")
    p = from_numpy_tree(np_tree(jget("adaptive").init(jax.random.key(1), 24, 32, MC)), "cpu")
    for T, want in ((512, 512), (513, 128)):
        x = torch.zeros((1, T, 24))
        y, lens = tdef.apply(p, x, torch.tensor([T], dtype=torch.int32))
        assert y.shape == (1, want, 32) and lens.tolist() == [want]


def test_perceiver_masks_the_mid_stream_audio_padding():
    """The perceiver's keys are [audio | video]: the audio's padding sits
    mid-stream and takes an explicit mask (mha_reference). Garbage in the
    padded audio rows changes nothing, in either package."""
    inputs, lens = dual_inputs(a_lens=(10, 5), v_lens=(4, 2))
    res_j, res_t = run_both("perceiver", (24, 16, 32), inputs, lens)
    assert_same(res_j, res_t)
    noisy = [inputs[0].copy(), inputs[1].copy()]
    noisy[0][1, 5:] = 1e3
    noisy[1][1, 2:] = -1e3
    res_j2, res_t2 = run_both("perceiver", (24, 16, 32), noisy, lens)
    torch.testing.assert_close(res_t2[0], res_t[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(res_j2[0]), np.asarray(res_j[0]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["cross_modal", "adapter"])
@pytest.mark.parametrize("a_lens,v_lens", [((10, 1), (1, 4)), ((3, 10), (4, 2)),
                                           ((0, 10), (0, 1))])
def test_video_alignment_with_ragged_lengths(name, a_lens, v_lens):
    """``cross_modal`` and ``adapter`` align the video to the audio grid;
    with ragged (and empty) lengths they equal JAX, and the one-hot product
    picks JAX's index clip(int(t * max(v,1) / max(a,1)), 0, Tv - 1)."""
    inputs, lens = dual_inputs(a_lens, v_lens, seed=6)
    assert_same(*run_both(name, (24, 16, 32), inputs, lens))
    v = torch.from_numpy(inputs[1])
    a_l, v_l = torch.tensor(a_lens), torch.tensor(v_lens)
    got = upsample_to(v, v_l, 10, a_l)
    ratio = jnp.maximum(jnp.asarray(v_lens), 1) / jnp.maximum(jnp.asarray(a_lens), 1)
    idx = jnp.clip((jnp.arange(10)[None, :] * ratio[:, None].astype(jnp.float32)
                    ).astype(jnp.int32), 0, 3)
    want = jnp.take_along_axis(jnp.asarray(inputs[1]), idx[..., None], axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_is_refused_and_unknown_names_raise_as_in_jax():
    """``moe`` is ported (``tests/test_torch_moe.py``): single-input, as in
    JAX. An unknown name raises JAX's KeyError."""
    assert not tget("moe").dual and not jget("moe").dual
    with pytest.raises(KeyError) as e_j:
        jget("nope")
    with pytest.raises(KeyError) as e_t:
        tget("nope")
    assert str(e_t.value) == str(e_j.value)
    assert all(tget(n).dual == jget(n).dual for n in SINGLE + DUAL + ("simple",))


def test_attention_connector_takes_no_kernel_on_the_cpu():
    """On CPU tensors the connectors' attention runs the plain versions:
    no kernel launch is counted."""
    inputs, lens = single_inputs(300, lens=(300, 211), seed=7)
    before = (tattn.launches, tattn.dq_launches, tattn.dkv_launches)
    run_both("attention", (24, 512), inputs, lens, use_kernel="auto")
    assert (tattn.launches, tattn.dq_launches, tattn.dkv_launches) == before
