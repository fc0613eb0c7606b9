"""Port CVNN layers and factory against the JAX package's.

Tier 1 (bit-exact): the seeded initial weights (threefry uniforms) and the
flat state-dict keys. Tier 2 (rtol 1e-5, atol 1e-6): forward outputs in
train and eval mode, batch-norm running-statistic updates, and gradients of
the same MSE (the port's autograd against ``jax.grad``), from the same
weights. Every linear layer maps a width to a different width, so a
transposed ``[in, out]`` load cannot pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralmc_tpu.models import cvnn as jc
from spectralmc_tpu.models import factory as jf
from spectralmc_tpu_torch.models import cvnn as tc
from spectralmc_tpu_torch.models import factory as tf

RTOL, ATOL = 1e-5, 1e-6


def _flat(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(p.key for p in path)] = np.asarray(leaf)
    return out


def _randomize(tree, gen: np.random.Generator, *, positive: tuple[str, ...] = ()):
    """Replace every leaf with random float32 values (positive for BN variances)."""

    def leaf(path, x):
        name = path[-1].key
        vals = gen.standard_normal(np.shape(x)).astype(np.float32) * 0.3
        if name in positive:
            vals = (np.abs(vals) + 0.5).astype(np.float32)
        return jnp.asarray(vals)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _load(module: torch.nn.Module, params, state) -> None:
    named = {**_flat(params), **_flat(state)}
    with torch.no_grad():
        for name, t in [*module.named_parameters(), *module.named_buffers()]:
            t.copy_(torch.from_numpy(np.array(named[name.replace(".", "/")])))
    assert len(named) == len([*module.named_parameters(), *module.named_buffers()])


def _inputs(batch: int, width: int, seed: int) -> tuple[np.ndarray, ...]:
    """``re, im`` of the input width and MSE targets wide enough for any output."""
    gen = np.random.default_rng(seed)
    return tuple(
        gen.standard_normal((batch, w)).astype(np.float32) for w in (width, width, 32, 32)
    )


def _layers():
    return {
        "linear": (jc.ComplexLinear(5, 7), tc.ComplexLinear(5, 7), 5),
        "linear_nobias": (jc.ComplexLinear(5, 7, bias=False), tc.ComplexLinear(5, 7, bias=False), 5),
        "zrelu": (jc.ZReLU(), tc.ZReLU(), 5),
        "modrelu": (jc.ModReLU(5), tc.ModReLU(5), 5),
        "naive_bn": (jc.NaiveComplexBatchNorm(5), tc.NaiveComplexBatchNorm(5), 5),
        "cov_bn": (jc.CovarianceComplexBatchNorm(5), tc.CovarianceComplexBatchNorm(5), 5),
        "sequential": (
            jc.ComplexSequential((jc.ComplexLinear(5, 7), jc.ModReLU(7))),
            tc.ComplexSequential((tc.ComplexLinear(5, 7), tc.ModReLU(7))),
            5,
        ),
        "residual": (
            jc.ComplexResidual(
                body=jc.ComplexSequential((jc.ComplexLinear(5, 7), jc.ZReLU())),
                projection=jc.ComplexLinear(5, 7, bias=False),
                post_activation=jc.ModReLU(7),
            ),
            tc.ComplexResidual(
                tc.ComplexSequential((tc.ComplexLinear(5, 7), tc.ZReLU())),
                tc.ComplexLinear(5, 7, bias=False),
                tc.ModReLU(7),
            ),
            5,
        ),
    }


def _compare(jlayer, tlayer, params, state, width: int, seed: int) -> None:
    """Forward (train + eval), state updates and MSE gradients agree."""
    re, im, t_re, t_im = _inputs(9, width, seed)

    def jloss(p):
        out_re, out_im, new_state = jlayer.apply(p, state, jnp.asarray(re), jnp.asarray(im), True)
        loss = jnp.mean(jnp.square(out_re - t_re[:, : out_re.shape[1]])) + jnp.mean(
            jnp.square(out_im - t_im[:, : out_im.shape[1]])
        )
        return loss, (out_re, out_im, new_state)

    (jl, (jre, jim, jstate)), jgrad = jax.value_and_grad(jloss, has_aux=True)(params)
    _load(tlayer, params, state)
    tlayer.train()
    out_re, out_im = tlayer(torch.from_numpy(re), torch.from_numpy(im))
    n = out_re.shape[1]
    tl = torch.mean(torch.square(out_re - torch.from_numpy(t_re[:, :n]))) + torch.mean(
        torch.square(out_im - torch.from_numpy(t_im[:, :n]))
    )
    named = dict(tlayer.named_parameters())
    grads = torch.autograd.grad(tl, list(named.values())) if named else ()
    np.testing.assert_allclose(out_re.detach().numpy(), np.asarray(jre), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_im.detach().numpy(), np.asarray(jim), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL, atol=ATOL)
    jg = _flat(jgrad)
    for (name, _), g in zip(named.items(), grads):
        np.testing.assert_allclose(g.numpy(), jg[name.replace(".", "/")], rtol=RTOL, atol=ATOL)
    for name, b in tlayer.named_buffers():  # running statistics after one train step
        np.testing.assert_allclose(b.numpy(), _flat(jstate)[name.replace(".", "/")],
                                   rtol=RTOL, atol=ATOL)
    tlayer.eval()
    with torch.no_grad():
        e_re, e_im = tlayer(torch.from_numpy(re), torch.from_numpy(im))
    j_re, j_im, _ = jlayer.apply(params, jstate, jnp.asarray(re), jnp.asarray(im), False)
    np.testing.assert_allclose(e_re.numpy(), np.asarray(j_re), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(e_im.numpy(), np.asarray(j_im), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(_layers()))
def test_layer_matches_jax(name: str) -> None:
    jlayer, tlayer, width = _layers()[name]
    params, state, _ = jlayer.init(jax.random.PRNGKey(3), width)
    gen = np.random.default_rng(17)
    params = _randomize(params, gen)
    state = _randomize(state, gen, positive=("var_re", "var_im", "c_rr", "c_ii"))
    _compare(jlayer, tlayer, params, state, width, seed=4)


def _config(mod, w: int):
    return mod.build_cvnn_config(
        layers=[
            mod.LinearCfg(width=w, activation=mod.Activation.MODRELU),
            mod.CovBNCfg(),
            mod.NaiveBNCfg(),
            mod.ResidualCfg(
                body=mod.SequentialCfg(layers=(
                    mod.LinearCfg(width=w + 4, activation=mod.Activation.ZRELU),
                    mod.LinearCfg(width=w + 4),
                )),
                activation=mod.Activation.MODRELU,
            ),
        ],
        seed=11,
        final_activation=mod.Activation.MODRELU,
    ).expect("cvnn config")


def test_seeded_init_is_bit_exact() -> None:
    jm = jf.build_model(_config(jf, 8), input_dim=6, output_dim=16).expect("jax model")
    tm = tf.build_model(_config(tf, 8), input_dim=6, output_dim=16).expect("port model")
    want = jf.get_state_dict(*jm.init())
    got = tf.get_state_dict(tm)
    assert set(want) == set(got)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_factory_model_from_jax_weights_matches() -> None:
    jm = jf.build_model(_config(jf, 8), input_dim=6, output_dim=16).expect("jax model")
    params, state = jm.init()
    gen = np.random.default_rng(2)
    params = _randomize(params, gen)
    state = _randomize(state, gen, positive=("var_re", "var_im", "c_rr", "c_ii"))
    tm = tf.build_model(_config(tf, 8), input_dim=6, output_dim=16).expect("port model")
    tf.load_state_dict(tm, jf.get_state_dict(params, state)).expect("load")
    _compare(jm._tree, tm, params, state, width=6, seed=8)


@pytest.mark.parametrize("input_dim", [10, 9], ids=["heston", "merton"])
def test_family_width_first_layer_carries_jax_weights(input_dim: int) -> None:
    """The Heston (10 inputs) and Merton (9 inputs) first layers, in ≠ out:
    seeded init bit-exact, and JAX weights carried across give the same
    forward (``_compare``'s tolerances)."""
    jm = jf.build_model(_config(jf, 8), input_dim=input_dim, output_dim=16).expect("jax model")
    tm = tf.build_model(_config(tf, 8), input_dim=input_dim, output_dim=16).expect("port model")
    params, state = jm.init()
    want, got = jf.get_state_dict(params, state), tf.get_state_dict(tm)
    assert got["params/layer_0/layer_0/w_re"].shape == want["params/layer_0/layer_0/w_re"].shape
    assert input_dim in got["params/layer_0/layer_0/w_re"].shape
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    gen = np.random.default_rng(input_dim)
    params = _randomize(params, gen)
    state = _randomize(state, gen, positive=("var_re", "var_im", "c_rr", "c_ii"))
    tf.load_state_dict(tm, jf.get_state_dict(params, state)).expect("load")
    back = tf.get_state_dict(tm)
    for key, value in jf.get_state_dict(params, state).items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    _compare(jm._tree, tm, params, state, width=input_dim, seed=8)


def test_load_state_dict_refuses_mismatches() -> None:
    tm = tf.build_model(_config(tf, 8), input_dim=6, output_dim=16).expect("port model")
    flat = tf.get_state_dict(tm)
    key = "params/layer_0/layer_0/w_re"
    wrong_shape = {**flat, key: flat[key].T.copy()}
    assert tf.load_state_dict(tm, wrong_shape).is_failure()
    missing = {k: v for k, v in flat.items() if k != key}
    res = tf.load_state_dict(tm, missing)
    assert res.is_failure() and res.error.key == key
    wrong_dtype = {**flat, key: flat[key].astype(np.float64)}
    assert tf.load_state_dict(tm, wrong_dtype).is_failure()
