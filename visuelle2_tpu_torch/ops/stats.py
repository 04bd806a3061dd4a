"""Statistical baselines (naive / SES / Holt), counterpart of
``visuelle2_tpu/ops/stats.py``.

Every method is computed in float32 on the device of ``X``, batched over
items and windows with plain tensor ops: the JAX ``vmap`` is broadcasting
here and its ``lax.scan`` over the window is a Python loop over T (2 weeks
in production).  The JAX package ran these through XLA, not Pallas, so no
kernel is written for them.

Semantics (the JAX module's, after ``Oracle.py:16-61`` of the reference):

* **naive** — teacher-forced: each window's last value; without it, the
  first window's last value repeated across windows.
* **SES** — α = 0.3 with the least-squares initial level, in closed form
  (the fitted values are affine in the initial level).
* **Holt** — on a 2-point window the exact linear extrapolation
  ``x1 + h·(x1 − x0)``; for T > 2 the SSE minimized over (α, β) and the free
  initial state (l0, b0): the state is affine in (l0, b0), so the inner
  problem is a 2-parameter least squares with the ridge
  ``1e-7·(g11 + g22) + 1e-30``, and (α, β) come from a 17 × 17 grid zoomed
  over three rounds, the best kept across rounds.

The grid is built the way ``jnp.linspace`` builds it (``linspace``), and
every sum over T is a fixed loop of elementwise ops, never a matmul: the
card and the CPU then give the same bits, so a near-tie in the grid's SSEs
picks the same point on both (``argmin`` takes the first minimum, as
``jnp.argmin`` does).
"""

from __future__ import annotations

import torch

SES_ALPHA = 0.3
HOLT_GRID = 17      # points a side of the (α, β) grid
HOLT_ROUNDS = 3     # zooming rounds
HOLT_LOW = 1e-4     # the grid's lower edge for α and β


def naive_forecast(X: torch.Tensor, teacher_forcing: bool) -> torch.Tensor:
    """X: [B, W, T] framed windows -> [B, W, 1]."""
    if teacher_forcing:
        y_hat = X[:, :, -1]
    else:
        y_hat = X[:, 0, -1][:, None].expand(-1, X.shape[1])
    return y_hat[..., None]


def _dot_over_t(a, b):
    """Σ_t a[..., t]·b[..., t] as a fixed loop over t (the same bits on any
    device)."""
    out = a[..., 0] * b[..., 0]
    for t in range(1, a.shape[-1]):
        out = out + a[..., t] * b[..., t]
    return out


def _ses_level_coeffs(x: torch.Tensor, alpha: float):
    """The SES recursion written affinely in the initial level: for x [N, T],
    the fitted values' coefficients ``(c [N, T], d [N, T])`` (fitted_t =
    c_t + d_t·l0, the level before x_t) and the end-of-sample level's
    ``(c_T, d_T)``."""
    c = torch.zeros_like(x[:, 0])
    d = torch.ones_like(x[:, 0])
    cs, ds = [], []
    for t in range(x.shape[1]):
        cs.append(c)
        ds.append(d)
        c = alpha * x[:, t] + (1 - alpha) * c
        d = (1 - alpha) * d
    return torch.stack(cs, 1), torch.stack(ds, 1), c, d


def ses_level(x: torch.Tensor, alpha: float = SES_ALPHA) -> torch.Tensor:
    """The SES level after the sample, x [N, T] -> [N], with the initial
    level l0* = Σ d_t(x_t − c_t) / Σ d_t² (the least-squares one)."""
    cs, ds, cT, dT = _ses_level_coeffs(x, alpha)
    l0 = _dot_over_t(ds, x - cs) / _dot_over_t(ds, ds)
    return cT + dT * l0


def ses_forecast(X: torch.Tensor, teacher_forcing: bool, alpha: float = SES_ALPHA):
    """Teacher-forced: a fit per window, one step ahead -> [B, W, 1].
    Without: a fit on the first window only, W steps ahead -> [B, 1, W]
    (the reference's layout)."""
    B, W, T = X.shape
    if teacher_forcing:
        return ses_level(X.reshape(B * W, T), alpha).reshape(B, W, 1)
    return ses_level(X[:, 0, :], alpha)[:, None, None].expand(B, 1, W)


def linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num, axis=-1)`` for float32 bounds in
    [1e-4, 1] and num ≤ 17, bit for bit: the k-th of the first num − 1 points
    is fma(stop, k/(num−1), f32(start·(1 − k/(num−1)))) — XLA contracts the
    last multiply-add into one rounding — and the last is ``stop``.  The fma
    is taken in float64: there the sum is exact (under 47 significant bits in
    that range), so its one rounding to float32 is the fma's."""
    div = num - 1
    step = torch.arange(div, dtype=start.dtype, device=start.device) / div
    head = (start[..., None] * (1 - step)).double()
    inner = (head + stop[..., None].double() * step.double()).to(start.dtype)
    return torch.cat([inner, stop[..., None]], dim=-1)


def _holt_affine_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """The Holt recursion with the state written affinely in the free initial
    state, for x [N, T] and a, b [N, K]: ``l_t = cl + dl·l0 + el·b0``,
    ``tr_t = ct + dt·l0 + et·b0``.  Returns the end-of-sample state's six
    coefficients and the fitted values' (fitted_t = l + tr before x_t), each
    fitted one [N, K, T]."""
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    cl, dl, el, ct, dt, et = zero, one, zero, zero, zero, one  # l = l0, tr = b0
    fcs, fds, fes = [], [], []
    for t in range(x.shape[1]):
        xt = x[:, t, None]
        fc, fd, fe = cl + ct, dl + dt, el + et
        fcs.append(fc)
        fds.append(fd)
        fes.append(fe)
        cl2 = a * xt + (1 - a) * fc                   # l' = a·x + (1-a)(l+tr)
        dl2, el2 = (1 - a) * fd, (1 - a) * fe
        ct = b * (cl2 - cl) + (1 - b) * ct            # tr' = b(l'-l) + (1-b)tr
        dt = b * (dl2 - dl) + (1 - b) * dt
        et = b * (el2 - el) + (1 - b) * et
        cl, dl, el = cl2, dl2, el2
    fitted = tuple(torch.stack(v, -1) for v in (fcs, fds, fes))
    return (cl, dl, el, ct, dt, et), fitted


def _holt_free_init_sse(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """For each (α, β) of a, b [N, K], the SSE minimized over the free
    initial state in closed form (statsmodels' objective), and the
    end-of-sample level and trend at the optimum: three [N, K] tensors."""
    (cl, dl, el, ct, dt, et), (fc, fd, fe) = _holt_affine_scan(x, a, b)
    r = x[:, None, :] - fc
    g11, g12, g22 = _dot_over_t(fd, fd), _dot_over_t(fd, fe), _dot_over_t(fe, fe)
    lam = 1e-7 * (g11 + g22) + 1e-30                  # ridge for degeneracy
    det = (g11 + lam) * (g22 + lam) - g12 * g12
    dr, er = _dot_over_t(fd, r), _dot_over_t(fe, r)
    l0 = ((g22 + lam) * dr - g12 * er) / det
    b0 = ((g11 + lam) * er - g12 * dr) / det
    resid = r - fd * l0[..., None] - fe * b0[..., None]
    return (_dot_over_t(resid, resid), cl + dl * l0 + el * b0, ct + dt * l0 + et * b0)


def holt_fit(x: torch.Tensor):
    """Holt's fit for T > 2 on x [N, T]: the end-of-sample level and trend
    [N] at the best (α, β) of the zooming grid, and the grid index each
    round picked [N, HOLT_ROUNDS] (a point k is α = grid_a[k % G], β =
    grid_b[k // G], ``jnp.meshgrid``'s order)."""
    N, G = x.shape[0], HOLT_GRID
    lo = torch.full((N, 2), HOLT_LOW, dtype=x.dtype, device=x.device)
    hi = torch.ones((N, 2), dtype=x.dtype, device=x.device)
    best_sse = torch.full((N,), float("inf"), dtype=x.dtype, device=x.device)
    best_l = torch.zeros((N,), dtype=x.dtype, device=x.device)
    best_b = torch.zeros_like(best_l)
    rows = torch.arange(N, device=x.device)
    picks = []
    for _ in range(HOLT_ROUNDS):
        ga, gb = linspace(lo[:, 0], hi[:, 0], G), linspace(lo[:, 1], hi[:, 1], G)
        a = ga[:, None, :].expand(N, G, G).reshape(N, G * G)
        b = gb[:, :, None].expand(N, G, G).reshape(N, G * G)
        sses, lTs, bTs = _holt_free_init_sse(x, a, b)
        i = torch.argmin(sses, dim=1)
        picks.append(i)
        take = sses[rows, i] < best_sse
        best_sse = torch.where(take, sses[rows, i], best_sse)
        best_l = torch.where(take, lTs[rows, i], best_l)
        best_b = torch.where(take, bTs[rows, i], best_b)
        step = (hi - lo) / (G - 1)
        ab = torch.stack([a[rows, i], b[rows, i]], dim=1)
        lo = torch.clamp(ab - step, HOLT_LOW, 1.0)
        hi = torch.clamp(ab + step, HOLT_LOW, 1.0)
    return best_l, best_b, torch.stack(picks, 1)


def holt_fit_forecast(x: torch.Tensor, horizon: int) -> torch.Tensor:
    """Holt's h-step forecasts [N, horizon] of each series of x [N, T]."""
    h = torch.arange(1, horizon + 1, dtype=x.dtype, device=x.device)
    if x.shape[1] == 2:
        # A 2-point window fits exactly for any (α, β).
        return x[:, 1, None] + h * (x[:, 1] - x[:, 0])[:, None]
    level, trend, _ = holt_fit(x)
    return level[:, None] + h * trend[:, None]


def holt_forecast(X: torch.Tensor, teacher_forcing: bool) -> torch.Tensor:
    """Layouts as ``ses_forecast``: [B, W, 1] teacher-forced, else [B, 1, W]."""
    B, W, T = X.shape
    if teacher_forcing:
        return holt_fit_forecast(X.reshape(B * W, T), 1).reshape(B, W, 1)
    return holt_fit_forecast(X[:, 0, :], W)[:, None, :]
