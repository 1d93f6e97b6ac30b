"""The port's degradation ops (rumpy_tpu_torch.ops: special, blur_kernels,
blur, noise, color_aug) against the JAX package's on the CPU. A torch
generator cannot reproduce jax.random streams, so each op is held with the
JAX side's own draws injected into the port's inner function."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.degradations.blur import RealESRGANBlur as JaxBlur
from rumpy_tpu.ops import blur as jblur
from rumpy_tpu.ops import blur_kernels as jbk
from rumpy_tpu.ops import color_aug as jcolor
from rumpy_tpu.ops import noise as jnoise
from rumpy_tpu.ops import special as jspecial
from rumpy_tpu_torch.config.constants import blur_kernel_codes
from rumpy_tpu_torch.degradations.blur import RealESRGANBlur
from rumpy_tpu_torch.ops import blur as tblur
from rumpy_tpu_torch.ops import blur_kernels as tbk
from rumpy_tpu_torch.ops import color_aug as tcolor
from rumpy_tpu_torch.ops import noise as tnoise
from rumpy_tpu_torch.ops import special as tspecial
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)


def _t(x):
    return torch.from_numpy(np.array(x))


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_j1_matches_jax():
    """Both branches and the switch at |x| = 8, on [-30, 30]: <= 1e-6."""
    x = np.linspace(-30.0, 30.0, 6001, dtype=np.float32)
    x = np.concatenate([x, np.float32([0.0, 7.9999995, 8.0, -8.0])])
    assert _err(tspecial.j1(_t(x)), jspecial.j1(x)) <= 1e-6


FAMILY_FUNCTIONS = {
    "gaussian": ("gaussian_kernels", ("sx", "sy", "th")),
    "generalized": ("generalized_gaussian_kernels", ("sx", "sy", "th", "beta")),
    "plateau": ("plateau_kernels", ("sx", "sy", "th", "beta")),
    "sinc": ("sinc_kernels", ("wc",)),
}


@pytest.mark.parametrize("family", sorted(FAMILY_FUNCTIONS))
@pytest.mark.parametrize("size", [7, 21])
def test_family_kernels_match_jax(family, size):
    """Each family's kernel function from the same parameters: <= 1e-6."""
    rng = np.random.default_rng(size)
    b = 16
    params = {"sx": rng.uniform(0.6, 5.0, b), "sy": rng.uniform(0.6, 5.0, b),
              "th": rng.uniform(-math.pi, math.pi, b), "beta": rng.uniform(0.5, 8.0, b),
              "wc": rng.uniform(math.pi / 3, math.pi, b)}
    name, args = FAMILY_FUNCTIONS[family]
    vals = [params[a].astype(np.float32) for a in args]
    want = getattr(jbk, name)(size, *[jnp.asarray(v) for v in vals])
    got = getattr(tbk, name)(size, *[_t(v) for v in vals])
    assert got.shape == (b, size, size) and got.dtype == torch.float32
    assert _err(got, want) <= 1e-6


def _jax_draws(key, batch, cfg):
    """The draws of the JAX package's sample_kernels, its key splits
    written out (rumpy_tpu/ops/blur_kernels.py:179-252)."""
    keys = jax.random.split(key, 8)
    names = cfg.kernel_range
    probs = np.asarray(cfg.kernel_probabilities or [1.0 / len(names)] * len(names))
    fam = jax.random.choice(keys[0], len(names), (batch,), p=jnp.asarray(probs / probs.sum()))
    uni = jbk._uniform

    def beta(k, rng_range):
        kg, kp, ks = jax.random.split(k, 3)
        below = jax.random.uniform(ks, (batch,)) < 0.5
        return jnp.where(below, uni(kg, batch, (rng_range[0], 1.0)),
                         uni(kp, batch, (1.0, rng_range[1])))

    noise = None
    if cfg.noise_range is not None:
        ks = cfg.kernel_size
        noise = jax.random.uniform(keys[7], (batch, ks, ks), minval=cfg.noise_range[0],
                                   maxval=cfg.noise_range[1])
    fields = dict(family=fam, sigma_x=uni(keys[1], batch, cfg.sigma_x_range),
                  sigma_y=uni(keys[2], batch, cfg.sigma_y_range),
                  rotation=uni(keys[3], batch, cfg.rotation_range),
                  beta_g=beta(keys[4], cfg.betag_range), beta_p=beta(keys[5], cfg.betap_range),
                  omega_c=uni(keys[6], batch, cfg.omega_c_range), noise=noise)
    return tbk.KernelDraws(**{k: (None if v is None else _t(v).to(
        torch.int64 if k == "family" else torch.float32)) for k, v in fields.items()})


SAMPLE_CFGS = {
    "bench": dict(kernel_range=("iso", "aniso")),
    "all": dict(kernel_range=jbk.ALL_KERNEL_TYPES),
    "all_noisy_weighted": dict(kernel_range=jbk.ALL_KERNEL_TYPES, noise_range=(0.75, 1.25),
                               kernel_probabilities=(0.1, 0.2, 0.1, 0.2, 0.1, 0.1, 0.2)),
    "no_sinc_noisy": dict(kernel_range=("generalized_iso", "plateau_aniso"),
                          noise_range=(0.9, 1.1), kernel_size=13),
}


@pytest.mark.parametrize("name", sorted(SAMPLE_CFGS))
def test_sample_kernels_with_jax_draws_match_jax(name):
    """Family selection, kernel noise (never on sinc) and metadata masks
    from the JAX side's draws: kernels and metadata <= 1e-6."""
    kw = SAMPLE_CFGS[name]
    jcfg, tcfg = jbk.BlurKernelConfig(**kw), tbk.BlurKernelConfig(**kw)
    key = jax.random.PRNGKey(7)
    want_k, want_m = jbk.sample_kernels(key, 64, jcfg)
    got_k, got_m = tbk.kernels_from_draws(tcfg, _jax_draws(key, 64, jcfg))
    assert _err(got_k, want_k) <= 1e-6
    assert sorted(got_m) == sorted(want_m)
    for k in want_m:
        assert got_m[k].shape == (64,) and _err(got_m[k], want_m[k]) <= 1e-6, k


def test_family_frequencies_within_binomial_bound():
    """4096 draws from the port's own generator: each family's count within
    5 sigma of its binomial mean."""
    probs = (0.05, 0.1, 0.15, 0.2, 0.2, 0.1, 0.2)
    cfg = tbk.BlurKernelConfig(kernel_range=tbk.ALL_KERNEL_TYPES, kernel_probabilities=probs)
    n = 4096
    d = tbk.draw_kernel_params(torch.Generator().manual_seed(0), n, cfg)
    counts = np.bincount(d.family.numpy(), minlength=len(probs))
    for c, p in zip(counts, probs):
        assert abs(c - n * p) <= 5 * math.sqrt(n * p * (1 - p)), (counts, probs)
    for k, (lo, hi) in (("sigma_x", cfg.sigma_x_range), ("omega_c", cfg.omega_c_range)):
        v = getattr(d, k)
        assert float(v.min()) >= lo and float(v.max()) <= hi
    assert float((d.beta_g < 1).float().mean()) == pytest.approx(0.5, abs=0.05)


def test_kernel_metadata_masks_and_sinc_rows():
    """RealESRGANBlur with every family: a field reads 0 unless the drawn
    family uses it; sinc rows keep zero (normalized) sigmas."""
    op = RealESRGANBlur(kernel_range="all", request_kernel_metadata=True)
    imgs = torch.rand(256, 24, 24, 3, generator=torch.Generator().manual_seed(1))
    out, meta = op.batch_apply(torch.Generator().manual_seed(2), imgs)
    assert out.shape == imgs.shape
    code = meta["kernel_type"].numpy().astype(int)
    names = [blur_kernel_codes[int(c)] for c in code]
    assert set(names) == set(tbk.ALL_KERNEL_TYPES)
    m = {k: v.numpy() for k, v in meta.items()}
    for i, n in enumerate(names):
        sinc = n == "sinc"
        assert (m["sigma_x"][i] == 0) == sinc and (m["sigma_y"][i] == 0) == sinc
        assert 0 <= m["sigma_x"][i] <= 1 and 0 <= m["sigma_y"][i] <= 1
        assert (m["rotation"][i] != 0) == (n in ("aniso", "generalized_aniso", "plateau_aniso"))
        assert (m["beta_g"][i] != 0) == n.startswith("generalized")
        assert (m["beta_p"][i] != 0) == n.startswith("plateau")
        assert (m["omega_c"][i] != 0) == sinc
        if n in ("iso", "generalized_iso", "plateau_iso"):
            assert m["sigma_x"][i] == m["sigma_y"][i]
    assert (m["kernel_size"] == 21).all()


@pytest.mark.parametrize("shape,ksize", [((3, 40, 36, 3), 21), ((2, 17, 23, 1), 13)])
def test_apply_kernels_matches_jax(shape, ksize):
    """Reflect pad and one grouped conv: <= 1e-5."""
    rng = np.random.default_rng(ksize)
    imgs = rng.random(shape, dtype=np.float32)
    cfg = jbk.BlurKernelConfig(kernel_size=ksize, kernel_range=jbk.ALL_KERNEL_TYPES)
    kernels, _ = jbk.sample_kernels(jax.random.PRNGKey(ksize), shape[0], cfg)
    want = jblur.apply_kernels(jnp.asarray(imgs), kernels)
    got = tblur.apply_kernels(_t(imgs), _t(kernels))
    assert got.shape == shape
    assert _err(got, want) <= 1e-5


@pytest.mark.parametrize("gray_prob", [0.0, 0.5, 1.0])
def test_gaussian_noise_with_the_same_field_matches_jax(gray_prob):
    """Sigma, gray flags and the unit field from the JAX key; output and
    scaled field <= 1e-6."""
    rng = np.random.default_rng(3)
    img = rng.random((6, 16, 20, 3), dtype=np.float32)
    key = jax.random.PRNGKey(11)
    want_out, want_meta, want_noise = jnoise.add_gaussian_noise(
        key, jnp.asarray(img), (1.0, 30.0), gray_prob, return_noise=True)
    k_sig, k_gray, k_noise = jax.random.split(key, 3)
    sigma = jax.random.uniform(k_sig, (6,), minval=1.0, maxval=30.0)
    gray = (jax.random.uniform(k_gray, (6,)) < gray_prob).astype(jnp.float32)
    field = jax.random.normal(k_noise, img.shape, jnp.float32)
    out, meta, noise = tnoise.apply_gaussian_noise(_t(img), _t(sigma), _t(gray), _t(field))
    assert _err(out, want_out) <= 1e-6 and _err(noise, want_noise) <= 1e-6
    for k in want_meta:
        assert _err(meta[k], want_meta[k]) <= 1e-6


@pytest.mark.parametrize("gray_prob", [0.0, 0.6])
def test_poisson_noise_with_the_same_samples_matches_jax(gray_prob):
    """Scale, gray flags and Poisson samples from the JAX key; output and
    scaled field <= 1e-6."""
    rng = np.random.default_rng(4)
    img = rng.random((5, 12, 18, 3), dtype=np.float32)
    key = jax.random.PRNGKey(12)
    want_out, _, want_noise = jnoise.add_poisson_noise(
        key, jnp.asarray(img), (0.05, 3.0), gray_prob, return_noise=True)
    k_scale, k_gray, k_poisson = jax.random.split(key, 3)
    scale = jax.random.uniform(k_scale, (5,), minval=0.05, maxval=3.0)
    gray = (jax.random.uniform(k_gray, (5,)) < gray_prob).astype(jnp.float32)
    rates = tnoise.poisson_rates(_t(img))
    rounded, gray_img, vals_c, vals_g = (np.asarray(r) for r in rates)
    sample_c = jax.random.poisson(k_poisson, jnp.asarray(rounded * vals_c))
    sample_g = jax.random.poisson(k_poisson, jnp.asarray(gray_img * vals_g))
    out, _, noise = tnoise.apply_poisson_noise(_t(img), _t(scale), _t(gray), _t(sample_c),
                                               _t(sample_g), rates)
    assert _err(out, want_out) <= 1e-6 and _err(noise, want_noise) <= 1e-6


def test_poisson_vals_are_exact():
    """2^ceil(log2(#levels)) from the 256-bin count, for images with 1 to
    256 distinct levels."""
    rng = np.random.default_rng(5)
    imgs = []
    for n_levels in (1, 2, 3, 17, 64, 65, 200, 256):
        levels = rng.choice(256, n_levels, replace=False)
        imgs.append(rng.choice(levels, (16, 16, 3)) / 255.0)
    imgs = np.stack(imgs).astype(np.float32)
    got = tnoise._poisson_vals(_t(imgs)).numpy()
    want = np.asarray(jnoise._poisson_vals(jnp.asarray(imgs)))
    np.testing.assert_array_equal(got, want)
    assert list(got) == [1, 2, 4, 32, 64, 128, 256, 256]


def _jax_colour_draws(key, n, strength):
    """The draws of the JAX package's colour_distortion, its key splits
    written out (rumpy_tpu/ops/color_aug.py:96-116)."""
    b, hmax = 0.8 * strength, 0.2 * strength
    k = jax.random.split(key, 5)
    factors = jnp.stack([
        jax.random.uniform(k[0], (n,), minval=max(0.0, 1 - b), maxval=1 + b),
        jax.random.uniform(k[1], (n,), minval=max(0.0, 1 - b), maxval=1 + b),
        jax.random.uniform(k[2], (n,), minval=max(0.0, 1 - b), maxval=1 + b),
        jax.random.uniform(k[3], (n,), minval=-hmax, maxval=hmax)], axis=1)
    u = jax.random.uniform(k[4], (n, 3))
    return (_t(factors), _t((u[:, 0] * 24).astype(jnp.int32)).long(),
            _t(u[:, 1] < 0.8), _t(u[:, 2] < 0.2))


@pytest.mark.parametrize("strength", [0.5, 1.0])
def test_colour_distortion_with_the_same_draws_matches_jax(strength):
    """24 images: every order and both flags occur among them; <= 1e-5."""
    rng = np.random.default_rng(6)
    imgs = rng.random((24, 10, 12, 3), dtype=np.float32)
    key = jax.random.PRNGKey(int(strength * 10))
    want = jcolor.colour_distortion(key, jnp.asarray(imgs), dist_strength=strength)
    draws = _jax_colour_draws(key, 24, strength)
    got = tcolor.apply_colour_distortion(_t(imgs), *draws)
    assert got.shape == imgs.shape
    assert _err(got, want) <= 1e-5
    assert draws[2].any() and (~draws[2]).any() and draws[3].any()


def test_colour_distortion_draws_in_range():
    f, perm, jitter, gray = tcolor.colour_distortion_draws(torch.Generator().manual_seed(0), 4096)
    assert float(f[:, :3].min()) >= 0.2 and float(f[:, :3].max()) <= 1.8
    assert float(f[:, 3].abs().max()) <= 0.2
    assert int(perm.min()) == 0 and int(perm.max()) == 23
    assert float(jitter.float().mean()) == pytest.approx(0.8, abs=0.03)
    assert float(gray.float().mean()) == pytest.approx(0.2, abs=0.03)
    imgs = torch.rand(6, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    out = tcolor.colour_distortion(torch.Generator().manual_seed(2), imgs)
    assert out.shape == imgs.shape and 0 <= float(out.min()) and float(out.max()) <= 1


def test_fixed_parameter_blur_matches_jax():
    """The fixed-parameter path draws nothing: one anisotropic plateau
    kernel for every example, output <= 1e-5 and metadata equal."""
    kw = dict(random_selection=False, selected_kernel="plateau_aniso", sigma_x=2.5,
              sigma_y=1.2, rotation=0.7, beta_p=1.5, request_kernel_metadata=True)
    imgs = np.random.default_rng(8).random((2, 30, 26, 3), dtype=np.float32)
    want, want_meta = JaxBlur(**kw).batch_apply(jax.random.PRNGKey(0), jnp.asarray(imgs))
    got, meta = RealESRGANBlur(**kw).batch_apply(torch.Generator(), _t(imgs))
    assert _err(got, want) <= 1e-5
    assert sorted(meta) == sorted(want_meta)
    for k in want_meta:
        assert _err(meta[k], want_meta[k]) <= 1e-6, k
