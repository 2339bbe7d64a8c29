"""Exact ALM line search: quartic minimization via closed-form cubic roots.

The 1-D restriction of the augmented Lagrangian along direction D is a
quartic phi(tau) = a*t^4 + b*t^3 + c*t^2 + d*t whose stationary points
come from the cubic 4a t^3 + 3b t^2 + 2c t + d = 0, solved in closed
form (Shengjin's formulas).  Mirrors the reference exactly:

* LORADScubic_equation (/root/reference/src_semi/lorads_alg/lorads_alm.c:114-154)
* ALMLineSearch        (/root/reference/src_semi/lorads_alg/lorads_alm.c:161-228)

Everything is branchless (jnp.where) so it runs inside jit/while_loop.
"""

from __future__ import annotations

import jax.numpy as jnp


def _nthroot3(x):
    """Signed cube root (reference LORADSnthroot, lorads_alm.c:102-112)."""
    return jnp.sign(x) * jnp.abs(x) ** (1.0 / 3.0)


def cubic_roots(a, b, c, d):
    """Roots of a*x^3 + b*x^2 + c*x + d = 0, Shengjin's formulas.

    Returns (roots[3], num_roots) exactly mirroring the reference's
    case split; invalid slots hold 0.0.  num_roots == 0 flags the
    degenerate case the reference treats as a numerical error.
    """
    A = b * b - 3.0 * a * c
    B = b * c - 9.0 * a * d
    C = c * c - 3.0 * b * d
    delta = B * B - 4.0 * A * C

    case1 = (A == 0.0) & (B == 0.0)
    case_d_pos = (~case1) & (delta > 0.0)
    case_d_zero = (~case1) & (delta == 0.0) & (A != 0.0) & (B != 0.0)
    case_d_neg = (~case1) & (delta < 0.0)

    # --- case 1: triple/degenerate root -c/b, clamped at 0 ---
    safe_b = jnp.where(b == 0.0, 1.0, b)
    r1_case1 = jnp.maximum(0.0, -c / safe_b)

    # --- delta > 0: one real root ---
    sq = jnp.sqrt(jnp.maximum(delta, 0.0))
    Y1 = A * b + 1.5 * a * (-B + sq)
    Y2 = A * b + 1.5 * a * (-B - sq)
    safe_a = jnp.where(a == 0.0, 1.0, a)
    r1_dpos = jnp.maximum(0.0, (-b - _nthroot3(Y1) - _nthroot3(Y2))
                          / (3.0 * safe_a))

    # --- delta == 0 (A,B nonzero): two roots ---
    safe_A = jnp.where(A == 0.0, 1.0, A)
    K = B / safe_A
    r1_dz = -b / safe_a + K
    r2_dz = -K / 2.0

    # --- delta < 0: three real roots ---
    sqA = jnp.sqrt(jnp.maximum(A, 0.0))
    safe_den = jnp.where(A * sqA == 0.0, 1.0, A * sqA)
    T = jnp.clip((A * b - 1.5 * a * B) / safe_den, -1.0, 1.0)
    theta = jnp.arccos(T)
    csth = jnp.cos(theta / 3.0)
    sn3th = jnp.sqrt(3.0) * jnp.sin(theta / 3.0)
    r1_dn = (-b - 2.0 * sqA * csth) / (3.0 * safe_a)
    r2_dn = (-b + sqA * (csth + sn3th)) / (3.0 * safe_a)
    r3_dn = (-b + sqA * (csth - sn3th)) / (3.0 * safe_a)

    zero = jnp.zeros_like(a)
    root1 = jnp.where(case1, r1_case1,
                      jnp.where(case_d_pos, r1_dpos,
                                jnp.where(case_d_zero, r1_dz,
                                          jnp.where(case_d_neg, r1_dn,
                                                    zero))))
    root2 = jnp.where(case_d_zero, r2_dz,
                      jnp.where(case_d_neg, r2_dn, zero))
    root3 = jnp.where(case_d_neg, r3_dn, zero)

    num = jnp.where(case1 | case_d_pos, 1,
                    jnp.where(case_d_zero, 2,
                              jnp.where(case_d_neg, 3, 0)))
    return jnp.stack([root1, root2, root3]), num


def _phi(a, b, c, d, x):
    return ((a * x + b) * x + c) * x * x + d * x


def alm_line_search(rho, lam, p1, p2, q0, q1, q2):
    """Minimize the quartic over tau in (0, 1].

    Inputs follow ALMLineSearch (lorads_alm.c:161-228):
      q0 = b - A(RR^T)   (pre lambda shift; shifted here)
      q1 = 2 A(sym(RD^T)), q2 = A(DD^T)
      p1 = 2 <C, sym(RD^T)>, p2 = <C, DD^T>

    Returns (tau, num_roots).  num_roots == 0 => numerical error.
    """
    q2n2 = jnp.vdot(q2, q2)
    a = rho * q2n2 / 2.0
    b = rho * jnp.vdot(q1, q2)
    q0s = q0 + lam / rho
    q1n2 = jnp.vdot(q1, q1)
    c = p2 - rho * jnp.vdot(q0s, q2) + rho * q1n2 / 2.0
    d = p1 - rho * jnp.vdot(q0s, q1)

    # Normalize the derivative cubic by its largest coefficient before
    # the discriminant: roots are scale-invariant, and B^2 - 4AC on the
    # raw coefficients overflows f32 for rho-scaled problems (observed
    # ~1e47), turning a healthy descent step into a spurious
    # "no root" numerical failure.
    ca, cb, cc, cd = 4.0 * a, 3.0 * b, 2.0 * c, d
    scale = jnp.maximum(
        jnp.maximum(jnp.abs(ca), jnp.abs(cb)),
        jnp.maximum(jnp.abs(cc), jnp.abs(cd)))
    scale = jnp.where(scale > 0, scale, 1.0)
    roots, num = cubic_roots(ca / scale, cb / scale, cc / scale,
                             cd / scale)

    f0 = jnp.zeros_like(a)
    f1 = _phi(a, b, c, d, 1.0)
    in_range = (roots > 1e-20) & (roots <= 1.0) & (
        jnp.arange(3) < num)
    froots = jnp.where(in_range, _phi(a, b, c, d, roots), 1e30)
    froots = jnp.where(jnp.isnan(froots), 1e30, froots)

    min_f = jnp.minimum(jnp.minimum(f0, f1), jnp.min(froots))
    # Selection priority (last assignment wins in the reference):
    # roots[2] > roots[1] > roots[0] > tau=1 > tau=0.
    tau = jnp.where(jnp.abs(min_f - f0) < 1e-10, 0.0, 0.0)
    tau = jnp.where(jnp.abs(min_f - f1) < 1e-10, 1.0, tau)
    tau = jnp.where(jnp.abs(min_f - froots[0]) < 1e-10, roots[0], tau)
    tau = jnp.where(jnp.abs(min_f - froots[1]) < 1e-10, roots[1], tau)
    tau = jnp.where(jnp.abs(min_f - froots[2]) < 1e-10, roots[2], tau)
    return tau, num
