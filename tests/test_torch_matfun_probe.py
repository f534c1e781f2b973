"""Two precision probes of ``chip_smoke.py``'s matrix-function block, on
its own inputs, and their CPU tests at a small size.

- ``tls_probe``: where TLS's x error on fitting-768x256 comes from.  The
  port's SVD (QDWH polar, then ``eigh`` of ``H = U_pᵀA``) is re-run all
  in float32 (the reference's rounding), with one kind of operation at a
  time in float64 and rounded back (the Gram products, as the port takes
  them on the card; the Cholesky factors; the triangular solves; ``H``'s
  product), with all four, with everything in float64, and all in float32
  with TF32 products allowed; each variant's x is held against numpy's
  float64 SVD of ``[A | b]``.
- ``nearness_probe``: nearness-128 with ``ops.nearness``'s ``eigh`` in
  float64 (the port's route) and with the library's float32 ``eigh`` (the
  reference's), each with its figures against ``chip_smoke.MF_LIMITS``
  and, on the card, its median time.

Run on the card (it needs no JAX):

    python tests/test_torch_matfun_probe.py [--lanes 32] [--out FILE]
"""

import argparse
import contextlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

#: the operations ``polar_variant`` can run in float64
HIGH_OPS = ("gram", "chol", "trsm", "H")
#: the TLS variants: the float64 operations (none: all float32, the port's
#: on the CPU; "gram": the port's on the card), or "f64" (the whole SVD in float64) or "tf32" (all float32
#: with TF32 products allowed)
TLS_VARIANTS = ((), ("gram",), ("chol",), ("trsm",), ("H",), HIGH_OPS,
                ("f64",), ("tf32",))
NEAR_KEYS = ("ncorr_diag", "ncorr_min_eig", "npsd_min_eig", "npsd_x")


def _maybe64(on, fn, *args):
    """``fn(*args)``, or in float64 and rounded back to float32."""
    if not on:
        return fn(*args)
    return fn(*(t.double() for t in args)).float()


def _tri(w, x):
    y = torch.linalg.solve_triangular(w, x.transpose(1, 2), upper=False)
    return torch.linalg.solve_triangular(w.transpose(1, 2), y, upper=True)


def polar_variant(a, high=(), iters=8):
    """``ops.svd.polar_batched``'s QDWH on float32 ``a`` with the
    operations named in ``high`` in float64; returns ``(up, H)``.  With
    ``high`` empty on the CPU, or ``("gram",)`` on the card, it is the
    port's, bit for bit."""
    from linalg_solver_tpu_torch.ops import svd as tsvd
    from linalg_solver_tpu_torch.ops.spd import cholesky_or_nan
    from linalg_solver_tpu_torch.utils.precision import f32_matmuls

    with f32_matmuls():
        n1 = a.abs().sum(dim=1).amax(dim=1)
        ninf = a.abs().sum(dim=2).amax(dim=1)
        alpha = torch.clamp(torch.sqrt(n1 * ninf), min=1e-30)
        x = a / alpha[:, None, None]
        n = a.shape[2]
        eye = torch.eye(n, dtype=x.dtype, device=x.device)
        l = torch.full((a.shape[0],), 1e-3, dtype=x.dtype, device=x.device)
        for _ in range(iters):
            ca, cb, cc, l = tsvd._qdwh_coeffs(l)
            gram = _maybe64("gram" in high,
                            lambda x_: x_.transpose(1, 2) @ x_, x)
            w = _maybe64("chol" in high, cholesky_or_nan,
                         eye + cc[:, None, None] * gram)
            y = _maybe64("trsm" in high, _tri, w, x)
            x = (cb / cc)[:, None, None] * x + (ca - cb / cc)[
                :, None, None] * y.transpose(1, 2)
        h = _maybe64("H" in high, lambda u, a_: u.transpose(1, 2) @ a_, x, a)
    return x, 0.5 * (h + h.transpose(1, 2))


def _tls_x(h, n):
    """TLS's x from ``H`` as ``ops.fitting.tls_batched`` takes it: the
    eigenvector of H's smallest eigenvalue (``ops.symmetric``'s float64
    ``eigh``)."""
    from linalg_solver_tpu_torch.ops.symmetric import eigh_batched

    v = eigh_batched(h).V[:, :, 0]
    return -v[:, :n] / v[:, n:n + 1]


def tls_probe(dev, lanes=None, x=None):
    """Each variant's TLS x error on the fitting cell's ``[A | b]``
    (``x``: ``mf_inputs()["fit"]``'s lanes by default): the worst and the
    median over the lanes of max|x - x64|, x64 from numpy's float64 SVD;
    and the port's own ``tls_batched`` error."""
    from linalg_solver_tpu_torch.ops import fitting
    from linalg_solver_tpu_torch.utils.precision import _matmuls

    a, b = x if x is not None else chip_smoke.mf_inputs()["fit"]
    a, b = a[:lanes], b[:lanes]
    n = a.shape[-1]
    want = []
    for k in range(a.shape[0]):
        _, _, vt = np.linalg.svd(np.concatenate(
            [a[k], b[k][:, None]], 1).astype(np.float64))
        want.append(-vt[-1, :n] / vt[-1, n])
    want = np.array(want)

    def err(xt):
        e = np.abs(xt.detach().cpu().double().numpy() - want).max(axis=1)
        return {"max": float(e.max()), "median": float(np.median(e))}

    ab = torch.cat([torch.from_numpy(a), torch.from_numpy(b)[:, :, None]],
                   2).to(dev)
    out = {"tls_batched": err(fitting.tls_batched(
        torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)).x)}
    for v in TLS_VARIANTS:
        name = "+".join(v) or "float32"
        if v == ("f64",):
            _, h = polar_variant(ab.double())
        elif v == ("tf32",):
            with _matmuls(True):
                _, h = _polar_tf32(ab)
        else:
            _, h = polar_variant(ab, v)
        out[name] = err(_tls_x(h, n))
    return out


def _polar_tf32(a):
    """``polar_variant`` with TF32 products allowed throughout (its
    ``f32_matmuls`` made a no-op)."""
    from linalg_solver_tpu_torch.utils import precision

    saved = precision.f32_matmuls
    precision.f32_matmuls = contextlib.nullcontext
    try:
        return polar_variant(a)
    finally:
        precision.f32_matmuls = saved


def _f32_eigh(a):
    """The library's float32 ``eigh`` of ``(a + aᵀ)/2`` as an
    ``EighResult``: the reference's ``jnp.linalg.eigh`` route."""
    from linalg_solver_tpu_torch.ops.symmetric import EighResult

    w, v = torch.linalg.eigh(0.5 * (a + a.transpose(1, 2)))
    return EighResult(w, v, torch.ones(a.shape[0], dtype=torch.bool,
                                       device=a.device))


def nearness_probe(dev, lanes=None, c=None, timed=True):
    """nearness-128 (``c``: ``mf_inputs()["near"]``'s lanes by default)
    with the float64 and the float32 ``eigh``: each route's figures,
    whether each is within ``MF_LIMITS``, the converged count and, where
    ``timed``, the median ms of the nearest correlation and PSD calls."""
    from linalg_solver_tpu_torch import ops
    from linalg_solver_tpu_torch.ops import nearness
    from linalg_solver_tpu_torch.utils.benchmarking import cuda_time

    c = (c if c is not None else chip_smoke.mf_inputs()["near"])[:lanes]
    ct = torch.from_numpy(c).to(dev)
    north = [chip_smoke._host_array(t)
             for t in ops.nearest_orthogonal_batched(ct)]
    out = {}
    for route, eigh in (("float64", nearness.eigh_batched),
                        ("float32", _f32_eigh)):
        saved = nearness.eigh_batched
        nearness.eigh_batched = eigh
        try:
            nc = ops.nearest_correlation_batched(ct)
            npsd = ops.nearest_psd_batched(ct)
            figs = chip_smoke.fig_nearness(c, chip_smoke._host(nc),
                                           chip_smoke._host(npsd), north)
            row = {k: figs[k] for k in NEAR_KEYS}
            row["within"] = {k: figs[k] <= chip_smoke.MF_LIMITS[k]
                             for k in NEAR_KEYS}
            row["ncorr_converged"] = figs["ncorr_converged"]
            row["ncorr_iters"] = figs["ncorr_iters"]
            if timed:
                row["ncorr_ms"] = 1e3 * cuda_time(
                    ops.nearest_correlation_batched, ct, warmup=0, iters=3)
                row["npsd_ms"] = 1e3 * cuda_time(
                    ops.nearest_psd_batched, ct, warmup=1, iters=5)
        finally:
            nearness.eigh_batched = saved
        out[route] = row
    return out


# --- CPU tests at a small size -----------------------------------------

SMALL = {"bsz": 2, "n": 16, "ps_b": 2, "ps_n": 12, "fn_b": 2, "fn_n": 12,
         "near_b": 2, "near_n": 12, "fit_b": 2, "fit_m": 36, "fit_n": 12}


@pytest.fixture(scope="module")
def small():
    return chip_smoke.mf_inputs(**SMALL)


def test_polar_variant_is_the_port_bit_for_bit(small):
    from linalg_solver_tpu_torch.ops.svd import polar_batched

    a, b = small["fit"]
    ab = torch.cat([torch.from_numpy(a), torch.from_numpy(b)[:, :, None]],
                   2)
    up, h = polar_variant(ab)
    ref = polar_batched(ab)
    assert torch.equal(up, ref.up) and torch.equal(h, ref.H)


def test_tls_probe_variants(small):
    out = tls_probe("cpu", x=small["fit"])
    assert set(out) == {"tls_batched", "float32", "gram", "chol", "trsm",
                        "H", "gram+chol+trsm+H", "f64", "tf32"}
    # on the CPU the port's own TLS is the all-float32 variant's x
    assert out["tls_batched"] == out["float32"]
    # the whole SVD in float64 leaves float64 rounding only
    assert out["f64"]["max"] < 1e-9 < out["float32"]["max"] < 1e-3


def test_nearness_probe_routes(small):
    out = nearness_probe("cpu", c=small["near"], timed=False)
    assert set(out) == {"float64", "float32"}
    for row in out.values():
        assert set(row) >= set(NEAR_KEYS) | {"within", "ncorr_converged"}
        assert row["ncorr_converged"] == SMALL["near_b"]
    # the float64 route is the port's: inside every limit
    assert all(out["float64"]["within"].values())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=None,
                    help="lanes of each batch (default: all)")
    ap.add_argument("--out", default="",
                    help="also write the JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probes time on the card: no CUDA device")
    res = {"card": chip_smoke.card_line(),
           "tls": tls_probe("cuda", args.lanes),
           "nearness": nearness_probe("cuda", args.lanes)}
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
