"""K4, the fused flat-mesh RK4 step.

``flat_rk4_step_plain`` (the kernel's plain version, which the CPU runs) is
held to the JAX package's Pallas kernel (``scripts/micro_pallas_rk4.py``'s
``_kernel``) run in interpret mode, and to the script's XLA version, at 4096
lanes: the script's unit cells mixed with lanes that reach every branch
(random convex quads, collinear and all-zero cells, NaN positions, NaN and
infinite t). dx/dy agree to rtol 1e-5 and atol 1e-6 with equal NaN masks;
rows 2-7 are exactly zero. Lanes on a branch near-tie at some stage (the two
roots' distances to 0.5, or the two denominators' magnitudes, within 1e-6,
where the two choices differ) are excluded; there are at most 0.1 % of them.
"""

import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from parcels_tpu_torch.ops import flat_rk4

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 4096
B = 2048


@pytest.fixture(scope="module")
def micro():
    """scripts/micro_pallas_rk4.py as a module; it edits sys.path at import,
    which is restored."""
    old_path = list(sys.path)
    try:
        sys.path.insert(0, str(ROOT / "scripts"))
        return importlib.import_module("micro_pallas_rk4")
    finally:
        sys.path[:] = old_path


@pytest.fixture(scope="module")
def inputs():
    return tuple(a.numpy() for a in flat_rk4.synthetic_inputs(N, seed=1, device="cpu",
                                                              branches=True))


def _branches(r, xq, yq):
    """The bilinear inverse's branch quantities at one stage (the formula of
    ``_bilinear_inverse_plain``): (near-tie lanes, aa != 0, pick1, use_x, q == 0)."""
    p1u, p1v, p2u, p2v, p3u, p3v = (r[k] for k in range(9, 15))
    a1, a2, a3 = p1u, p3u, -p1u + p2u - p3u
    b1, b2, b3 = p1v, p3v, p2v - p1v - p3v
    aa = a3 * b2 - a2 * b3
    bb = a1 * b2 - a2 * b1 + xq * b3 - yq * a3
    cc = xq * b1 - yq * a1
    det = torch.sqrt(torch.clamp_min(bb * bb - 4 * aa * cc, 0.0))
    q = -0.5 * (bb + torch.where(bb >= 0, 1.0, -1.0) * det)
    r2 = cc / torch.where(q == 0.0, 1.0, q)
    r1 = torch.where(aa == 0.0, r2, q / torch.where(aa == 0.0, 1.0, aa))
    r2 = torch.where(q == 0.0, 0.0, r2)
    d1, d2 = torch.abs(r1 - 0.5), torch.abs(r2 - 0.5)
    eta = torch.where(d1 <= d2, r1, r2)
    denx, deny = a1 + a3 * eta, b1 + b3 * eta
    xs_x = (xq - a2 * eta) / torch.where(denx == 0.0, 1.0, denx)
    xs_y = (yq - b2 * eta) / torch.where(deny == 0.0, 1.0, deny)
    # two exact zero denominators (the all-zero cell) are no rounding tie
    tie = (((d1 - d2).abs() < 1e-6) & (r1 != r2)) | (
        ((denx.abs() - deny.abs()).abs() < 1e-6) & (xs_x != xs_y)
        & ((denx != 0) | (deny != 0)))
    return tie, aa != 0, d1 <= d2, denx.abs() >= deny.abs(), q == 0


def _stage_branches(row, uv, scal):
    """Branch quantities at each RK stage's position, OR-ed (tie) or listed."""
    r, uvt = torch.as_tensor(row), torch.as_tensor(uv)
    x, y, t, dt = (torch.as_tensor(scal[k]) for k in range(4))
    tau = t * 0.0
    pos, out = (x, y), []
    for f in (0.5, 0.5, 1.0, None):
        xs, ys = pos
        dx, dy = xs - r[0], ys - r[1]
        out.append(_branches(r, dx * r[3] + dy * r[4], dx * r[6] + dy * r[7]))
        if f is not None:
            u, v = flat_rk4._stage_plain(r, uvt, xs, ys, tau)
            pos = (x + f * dt * u, y + f * dt * v)
    return out


def _compare(got, ref, row, uv, scal):
    stages = _stage_branches(row, uv, scal)
    tie = np.zeros(N, bool)
    for s in stages:
        tie |= s[0].numpy()
    assert tie.sum() <= 1e-3 * N, tie.sum()
    np.testing.assert_array_equal(np.isnan(got[:2]), np.isnan(ref[:2]))
    keep = ~tie
    np.testing.assert_allclose(got[:2, keep], ref[:2, keep], rtol=1e-5, atol=1e-6,
                               equal_nan=True)
    assert (got[2:] == 0).all() and (ref[2:] == 0).all()
    # NaN positions and NaN or infinite t give NaN steps
    bad = np.isnan(scal[0]) | ~np.isfinite(scal[2])
    assert bad.any() and np.isnan(got[0][bad]).all() and np.isnan(ref[0][bad]).all()
    assert np.isfinite(got[:2, ~bad]).all()
    # the inputs reach every branch of the bilinear inverse at stage 1
    _, quad, pick1, use_x, q0 = (v.numpy() for v in stages[0])
    assert quad.any() and (~quad).any() and q0.any()
    for flag in (pick1, use_x):
        assert flag[quad].any() and (~flag[quad]).any()


def test_plain_matches_pallas_interpret(micro, inputs):
    row, uv, scal = inputs
    ref = np.asarray(pl.pallas_call(
        micro._kernel, grid=(N // B,),
        in_specs=[pl.BlockSpec((32, B), lambda i: (0, i)), pl.BlockSpec((8, B), lambda i: (0, i)),
                  pl.BlockSpec((8, B), lambda i: (0, i))],
        out_specs=pl.BlockSpec((8, B), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((8, N), jnp.float32), interpret=True,
    )(jnp.asarray(row), jnp.asarray(uv), jnp.asarray(scal)))
    got = flat_rk4.flat_rk4_step(*(torch.as_tensor(a) for a in inputs)).numpy()
    _compare(got, ref, row, uv, scal)


def test_plain_matches_script_xla(micro, inputs):
    row, uv, scal = inputs
    ref = np.asarray(micro.run_xla(False)(jnp.asarray(row), jnp.asarray(uv), jnp.asarray(scal)))
    got = flat_rk4.flat_rk4_step_plain(*(torch.as_tensor(a) for a in inputs)).numpy()
    _compare(got, ref, row, uv, scal)


def test_unit_cells_are_the_scripts_and_stay_in_cell():
    """The script's inputs: unit squares (linear branch only), points inside,
    dt 0.3, finite steps; the wrapper counts no launch on the CPU."""
    row, uv, scal = flat_rk4.synthetic_inputs(1000, seed=0, device="cpu")
    np.testing.assert_array_equal(row[9:15, 0].numpy(), [1, 0, 1, 1, 0, 1])
    np.testing.assert_array_equal(row[16:24, 0].numpy(), [1, 1, 0, 0, 1, 1, 0, 1])
    launches = flat_rk4.flat_rk4_step.launches
    out = flat_rk4.flat_rk4_step(row, uv, scal)
    assert flat_rk4.flat_rk4_step.launches == launches
    assert out.shape == (8, 1000) and torch.isfinite(out).all()
    assert (out[:2].abs() < 0.3 * 0.3 * 4).all()


def test_wrapper_checks_its_inputs():
    row, uv, scal = flat_rk4.synthetic_inputs(8, device="cpu")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flat_rk4.flat_rk4_step(row.to("meta"), uv, scal)
    assert flat_rk4.BYTES_PER_LANE == 160


def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n = 5 * 2048 + 3  # not a multiple of the block
    row, uv, scal = flat_rk4.synthetic_inputs(n, seed=2, device="cuda", branches=True)
    got = flat_rk4.flat_rk4_step(row, uv, scal)
    torch.cuda.synchronize()
    want = flat_rk4.flat_rk4_step_plain(row, uv, scal)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
