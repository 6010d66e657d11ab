"""The port's Swin backbone against the JAX package, same weights and inputs.

flax ``init`` makes the weights (biases and relative-position tables are
overwritten with seeded normal values, or a broken bias path would pass),
``params_from_jax`` carries them into the port with ``strict=True``, numpy
makes the input; both run in float32 on the CPU. On the CPU the JAX module
takes its einsum path (scale on q) and the port the plain version of its
fused wrapper (scale on the scores): equal in float32 to rounding. The input
is 70 × 90, not a multiple of the patch or the window, so that padding,
shifted windows with their mask, and a shrunk window (3 × 3 map in the last
stage) all occur. Tolerance: max |Δ| ≤ 1e-4 · max |reference|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.backbone import swin as jswin
from divergen_tpu_torch.modeling.backbone import swin as tswin
from divergen_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
TOL = 1e-4
TINY = dict(embed_dim=16, depths=(2, 1, 2, 1), num_heads=(1, 2, 4, 8), window=4)
SIZE = (70, 90)


def assert_rel_close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def randomized(params, rng):
    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "relative_position_bias_table":
                out[k] = (rng.randn(*v.shape) * 0.5).astype(np.float32)
            elif k == "bias":
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(jax.tree.map(np.asarray, params))


def load(module, params):
    module.load_state_dict(params_from_jax(params, module), strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def tiny_swin():
    rng = np.random.RandomState(0)
    x = rng.randn(2, *SIZE, 3).astype(np.float32)
    jm = jswin.SwinTransformer(**TINY)
    params = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = jax.jit(lambda p, a: jm.apply(p, a))(params, jnp.asarray(x))
    return x, params, jax.tree.map(np.asarray, want)


def test_swin_features(tiny_swin):
    x, params, want = tiny_swin
    tm = load(tswin.SwinTransformer(**TINY, input_size=SIZE), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert set(got) == set(want) == {"s2", "s3", "s4", "s5"}
    for name in want:
        assert_rel_close(got[name].numpy(), want[name])


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
def test_window_attention_module_six_heads(with_mask):
    """Six heads of 32 channels, the head count of Swin-L's first stage: the
    port sends it through the packed wrapper like any other."""
    rng = np.random.RandomState(4)
    window, heads, nw = 3, 6, 2
    n, dim = window * window, 32 * heads
    x = rng.randn(2 * nw, n, dim).astype(np.float32)
    mask = np.where(rng.rand(nw, n, n) < 0.3, -100.0, 0.0).astype(np.float32) if with_mask else None
    jm = jswin.WindowAttention(dim=dim, window=window, num_heads=heads)
    jmask = None if mask is None else jnp.asarray(mask)
    params = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jmask), rng)
    tm = load(tswin.WindowAttention(dim, window, heads), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert_rel_close(got.numpy(), jm.apply(params, jnp.asarray(x), jmask))


def test_swin_table_sizes_follow_the_built_size(tiny_swin):
    """The last stage sees a 3 × 3 map: its table has (2·3 − 1)² rows in the
    flax tree, and a module built without the size does not load it."""
    _, params, _ = tiny_swin
    table = params["params"]["stage3_block0"]["attn"]["relative_position_bias_table"]
    assert table.shape == (25, 8)
    full = tswin.SwinTransformer(**TINY)
    assert full.stage3_block0.attn.relative_position_bias_table.shape == (49, 8)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load(full, params)


def test_swin_refuses_another_size_than_built(tiny_swin):
    x, params, _ = tiny_swin
    tm = load(tswin.SwinTransformer(**TINY, input_size=SIZE), params)
    with pytest.raises(ValueError, match="built for windows of 3"):
        tm(torch.zeros(1, 128, 128, 3))
    full = tswin.SwinTransformer(**TINY)
    with pytest.raises(ValueError, match="built for windows of 4"):
        full(torch.from_numpy(x))
    out = full(torch.zeros(1, 128, 128, 3))  # 4 × 4 in the last stage: no shrinking
    assert out["s5"].shape == (1, 4, 4, 128)


def test_swin_remat_is_accepted_and_out_features_select(tiny_swin):
    x, params, want = tiny_swin
    tm = tswin.SwinTransformer(**TINY, input_size=SIZE, remat=True, out_features=("s3", "s5"))
    sd = {k: v for k, v in params_from_jax(params, None).items()
          if not k.startswith(("s2_norm", "s4_norm"))}
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert set(got) == {"s3", "s5"}
    assert_rel_close(got["s5"].numpy(), want["s5"])


@pytest.mark.parametrize("h,w", [(6, 8), (5, 7)], ids=["even", "odd"])
def test_patch_merging(h, w):
    rng = np.random.RandomState(1)
    x = rng.randn(2, h, w, 8).astype(np.float32)
    jm = jswin.PatchMerging(8)
    params = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tm = load(tswin.PatchMerging(8), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_rel_close(got.numpy(), jm.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("shift", [0, 2], ids=["plain", "shifted"])
def test_swin_block(shift):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 11, 32).astype(np.float32)
    jm = jswin.SwinBlock(dim=32, num_heads=2, window=4, shift=shift)
    params = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tm = load(tswin.SwinBlock(32, 2, 4, shift), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_rel_close(got.numpy(), jm.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("window", [3, 4, 7, 12])
def test_relative_position_index(window):
    np.testing.assert_array_equal(tswin._relative_position_index(window),
                                  jswin._relative_position_index(window))


@pytest.mark.parametrize("hp,wp,window,shift", [(8, 8, 4, 2), (12, 20, 4, 2), (14, 7, 7, 3)])
def test_shift_attn_mask(hp, wp, window, shift):
    want = jswin._shift_attn_mask(hp, wp, window, shift)
    np.testing.assert_array_equal(tswin._shift_attn_mask(hp, wp, window, shift), want)
    on = tswin._shift_attn_mask_on(hp, wp, window, shift, torch.device("cpu"))
    np.testing.assert_array_equal(on.numpy(), want)


def test_window_partition_and_reverse():
    x = np.random.RandomState(3).randn(2, 8, 12, 5).astype(np.float32)
    want = np.asarray(jswin.window_partition(jnp.asarray(x), 4))
    got = tswin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tswin.window_reverse(got, 4, 8, 12).numpy(), x)


def test_size2config_and_from_size():
    assert tswin.SIZE2CONFIG == jswin.SIZE2CONFIG
    sizes = tswin.stage_map_sizes((896, 896), 4, 4)
    assert sizes == ((224, 224), (112, 112), (56, 56), (28, 28))
    assert tswin.stage_map_sizes((70, 90), 4, 4) == ((18, 23), (9, 12), (5, 6), (3, 3))


def test_drop_path_is_identity_when_deterministic():
    from divergen_tpu_torch.modeling.layers import DropPath

    x = torch.randn(4, 3, 3, 2)
    assert DropPath(0.5)(x, deterministic=True) is x
    gen = torch.Generator().manual_seed(0)
    y = DropPath(0.5)(x, deterministic=False, generator=gen)
    kept = (y != 0).flatten(1).any(dim=1)
    torch.testing.assert_close(y[kept], x[kept] * 2.0)
    assert not y[~kept].any()
