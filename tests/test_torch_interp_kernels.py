"""K1 (fold sampler) of the port against parcels_tpu's, same inputs.

The plain version of the port's K1 is compared with the JAX Pallas kernel
in interpret mode and with the JAX ``_linear_sample`` on evaluated lanes,
at rtol 2e-4 / atol 2e-5: the JAX package's own tolerance for its hat
contraction against the gather path (tests/test_binned_sample.py), which
covers the different summation orders (matrix-unit contraction vs. 16
corner loads). The kernel on the card is held to its plain version bit for
bit (both round every product and sum in f32 in the same order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parcels_tpu.ops import interp_kernels as jik
from parcels_tpu_torch.ops import interp_kernels as tik

TOL = dict(rtol=2e-4, atol=2e-5)


def _positions(rng, n, shape):
    return [rng.uniform(-0.5, d - 0.5, n).astype(np.float32) for d in shape]


def test_plain_matches_pallas_kernel():
    """Against _pallas_sample (interpret mode), including lanes whose time
    position lies outside the fold (-10: zero weight)."""
    rng = np.random.default_rng(7)
    W, Z, Y, X = 4, 4, 16, 24
    data = rng.normal(size=(W, Z, Y, X)).astype(np.float32)
    R = W * Z * Y
    f2 = np.pad(data.reshape(R, X), ((0, -(-R // 8) * 8 - R), (0, 128 - X)))
    n = 300
    pos = _positions(rng, n, (W, Z, Y, X))
    pos[0][::17] = -10.0
    want = np.asarray(jik._pallas_sample(jnp.asarray(f2), *map(jnp.asarray, pos), Z, Y))
    got = tik.fold_sample(torch.as_tensor(data), *map(torch.as_tensor, pos)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[::17] == 0.0)


@pytest.mark.parametrize("shape", [(4, 4, 16, 600), (3, 1, 20, 30), (1, 1, 8, 8), (2, 3, 5, 7)])
def test_fits_fast_path_matches(shape):
    assert tik.fits_fast_path(shape) == jik.fits_fast_path(shape)


@pytest.mark.parametrize("shape", [(4, 4, 16, 600), (3, 2, 12, 20)])
def test_linear_sample_matches_reference(shape, monkeypatch):
    """The JAX dispatcher (Pallas fold in interpret mode, or its XLA
    contraction for small folds) against the port's dispatcher (K1's plain
    version on the CPU) on in-bounds lanes, with degenerate axes pinned."""
    from parcels_tpu.interpolators.xinterp import _linear_sample as j_linear
    from parcels_tpu_torch.interpolators.xinterp import _linear_sample as t_linear
    from parcels_tpu_torch.interpolators.xinterp import gather_sample

    monkeypatch.setenv("PARCELS_TPU_FORCE_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(11)
    data = rng.uniform(-1, 1, shape).astype(np.float32)
    n = 700
    idx = {ax: rng.integers(0, max(d - 1, 1), n).astype(np.int32) for ax, d in zip("TZYX", shape)}
    bc = {ax: rng.uniform(0, 1, n).astype(np.float32) for ax in "TZYX"}
    for ax, d in zip("TZYX", shape):
        if d == 1:
            idx[ax][:] = 0
            bc[ax][:] = 0.0
    jg = {ax: {"index": jnp.asarray(idx[ax]), "bcoord": jnp.asarray(bc[ax])} for ax in "TZYX"}
    tg = {ax: {"index": torch.as_tensor(idx[ax]), "bcoord": torch.as_tensor(bc[ax])} for ax in "TZYX"}
    want = np.asarray(j_linear(jnp.asarray(data), jg))
    got = t_linear(torch.as_tensor(data), tg).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # K1 equals the plain gather path on every in-bounds lane
    np.testing.assert_allclose(got, gather_sample(torch.as_tensor(data), tg).numpy(), **TOL)


def test_positions_from_gpos_matches():
    rng = np.random.default_rng(5)
    shape = (3, 1, 9, 11)
    idx = {ax: rng.integers(-2, 8, 50).astype(np.int32) for ax in "TZYX"}
    bc = {ax: rng.uniform(0, 1, 50).astype(np.float32) for ax in "TZYX"}
    jg = {ax: {"index": jnp.asarray(idx[ax]), "bcoord": jnp.asarray(bc[ax])} for ax in "TZYX"}
    tg = {ax: {"index": torch.as_tensor(idx[ax]), "bcoord": torch.as_tensor(bc[ax])} for ax in "TZYX"}
    for a, b in zip(tik.positions_from_gpos(tg, shape), jik.positions_from_gpos(jg, shape)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_plain_handles_edges():
    """Corners outside the field contribute nothing; NaN positions give NaN."""
    data = torch.ones((2, 1, 3, 3))
    p = [torch.tensor(v, dtype=torch.float32) for v in (
        [0.5, -1.0, 0.0, float("nan"), 1.0],
        [0.0, 0.0, 0.0, 0.0, 0.0],
        [1.0, 1.0, 2.5, 1.0, 1e30],
        [1.0, 1.0, 1.0, 1.0, 1.0],
    )]
    got = tik.fold_sample(data, *p).numpy()
    np.testing.assert_allclose(got[:3], [1.0, 0.0, 0.5])
    assert np.isnan(got[3]) and got[4] == 0.0


def test_kernel_matches_plain_on_card():
    """Bit for bit on the card (NaN lanes included): uniform lanes at the K1
    path's shape, then edge positions (x0 = X - 1, x0 % 4 == 3, far-out and
    NaN) on degenerate T and Z axes and X % 4 != 0, each field also with a
    base off 16-byte alignment (the kernel's 4-byte load path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(3)
    shape = (24, 1, 256, 1000)
    data = torch.as_tensor(rng.uniform(-1, 1, shape).astype(np.float32), device="cuda")
    pos = [torch.as_tensor(p, device="cuda") for p in _positions(rng, 1 << 16, shape)]
    got = tik.fold_sample(data, *pos)
    torch.cuda.synchronize()
    want = tik.fold_sample_plain(data, *pos)
    assert torch.equal(got, want)
    for i, shape in enumerate([(1, 1, 8, 8), (3, 4, 10, 130), (1, 3, 16, 67), (4, 1, 16, 64),
                               (24, 1, 256, 1000)]):
        data = torch.as_tensor(rng.uniform(-1, 1, shape).astype(np.float32), device="cuda")
        flat = torch.empty(data.numel() + 1, device="cuda")
        shifted = flat[1:].view(shape)
        shifted.copy_(data)
        pos = tik.edge_positions(shape, 20000, seed=i, device="cuda")
        want = tik.fold_sample_plain(data, *pos)
        for field in (data, shifted):
            got = tik.fold_sample(field, *pos)
            assert torch.equal(torch.isnan(got), torch.isnan(want)), shape
            assert torch.equal(got.nan_to_num(), want.nan_to_num()), shape
