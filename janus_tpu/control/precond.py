"""Krylov preconditioners (the reference's GMRES+ILU role, batched).

The reference pairs GMRES with ILU factorizations
(src/python/odesolvers/linsolve.py:60-111) and PETSc shell preconditioners
(examples/cpp/vdp_shell.cpp). ILU is a sequential sparse triangular sweep —
the wrong shape for batched XLA code. The same *role* (cheap approximate inverse that
clusters the spectrum) maps here onto structures the hardware likes:

- **block-Jacobi**: the Jacobian's diagonal blocks, probed with `block`
  colored jvp's (Curtis–Powell–Reid style) and factored with the repo's
  batched unrolled LU — [M, nb, b, b] batched elementwise work, zero gathers.
- **tridiagonal**: the three diagonals probed with 3 colored jvp's, applied
  with a Thomas sweep under `lax.scan` (each scan step is an [M]-vectorized
  elementwise op — sequential in N but trivially wide in the batch).

Both are *approximations* when J has entries outside the assumed structure
(coloring folds same-color columns together); that is standard and fine for
preconditioning — they are exact when J matches the structure (block
diagonal / tridiagonal), which is the method-of-lines regime they target.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from janus_tpu.linalg.smalllu import lu_factor, lu_solve


def probe_colored_jacobian(f: Callable, x, ncolors: int):
    """Colored Jacobian probing: J's action on the `ncolors` comb vectors.

    Returns cols[c] = J @ v_c with v_c[j] = (j % ncolors == c), as an array
    [ncolors, M, N]. For a banded J with bandwidth < ncolors, column j of J
    is recovered exactly as cols[j % ncolors] restricted to rows near j.
    """
    n = x.shape[-1]
    probes = (jnp.arange(n)[None, :] % ncolors ==
              jnp.arange(ncolors)[:, None]).astype(x.dtype)    # [C, N]

    def one(v):
        _, out = jax.jvp(f, (x,), (jnp.broadcast_to(v, x.shape),))
        return out

    return jax.vmap(one)(probes)                               # [C, M, N]


def probe_custom_colors(f: Callable, x, colors, ncolors: int):
    """Colored Jacobian probing with an arbitrary color assignment.

    colors: [N] int array mapping column j to its color. Returns
    cols[c] = J @ v_c with v_c[j] = (colors[j] == c), as [ncolors, M, N].
    Entry J[i, j] is recovered exactly from cols[colors[j]][i] whenever no
    OTHER nonzero column of row i shares color colors[j]."""
    probes = (colors[None, :] ==
              jnp.arange(ncolors)[:, None]).astype(x.dtype)     # [C, N]

    def one(v):
        _, out = jax.jvp(f, (x,), (jnp.broadcast_to(v, x.shape),))
        return out

    return jax.vmap(one)(probes)                               # [C, M, N]


def line_tridiag_bands(f: Callable, x, block: int):
    """In-line tridiagonal bands (dl, d, du) of J for a LINE-BLOCKED state
    layout: the state is ``nb`` consecutive lines of length ``block`` (e.g.
    the rows of an [ny, nx] 2-D MOL grid, or one species' grid in a
    species-major multi-species layout).

    Probing uses 6 colors — (j mod 3) crossed with line parity
    ((j // block) mod 2) — so couplings into ADJACENT lines (the ±block
    offsets of 5/9-point stencils) land in the other parity group and can
    never alias onto the in-line bands, unlike the plain 3-color
    ``tridiag_bands`` (where e.g. block % 3 == 0 folds the ±block diffusion
    couplings straight onto the diagonal). In-line couplings at |offset| ≥ 2
    and couplings two lines away still alias (same 3-color limit as the 1-D
    extractor). dl/du are zero at line boundaries, so a single Thomas/PCR
    sweep over the full length-N array solves the line-block system exactly
    (the zeros decouple the lines).
    """
    m, n = x.shape
    if block < 2 or n % block != 0:
        raise ValueError(f"N={n} not divisible by line length block={block}")
    j = jnp.arange(n)
    colors = (j % 3) + 3 * ((j // block) % 2)
    cols = probe_custom_colors(f, x, colors, 6)                # [6, M, N]
    pick = jnp.moveaxis(cols, 0, -1)                           # [M, N, 6]
    par3 = 3 * ((j // block) % 2)

    def diag_at(offset):
        pos = (j % block) + offset
        valid = (pos >= 0) & (pos < block)
        cread = (j + offset) % 3 + par3
        onehot = (cread[:, None] == jnp.arange(6)[None, :]) & valid[:, None]
        return jnp.sum(jnp.where(onehot[None], pick, 0.0), axis=-1)

    return diag_at(-1), diag_at(0), diag_at(1)


def blocks_of_jacobian(f: Callable, x, block: int):
    """Diagonal blocks of J at ``x``: [M, nb, b, b] from 2b colored jvp's.

    Parity-extended coloring ((j mod b) crossed with block parity) makes the
    extraction EXACT whenever every cross-block coupling goes to an ADJACENT
    block (cell-interleaved MOL layouts: reaction terms are in-block,
    spatial neighbors are ±b). Couplings two or more blocks away alias.
    """
    m, n = x.shape
    b = block
    if b < 1 or n % b != 0:
        raise ValueError(f"N={n} not divisible by block={b}")
    nb = n // b
    j = jnp.arange(n)
    colors = (j % b) + b * ((j // b) % 2)
    cols = probe_custom_colors(f, x, colors, 2 * b)            # [2b, M, N]
    # pk[m, k, r, c, parity] = cols[parity*b + c][m, k*b + r]
    pk = jnp.transpose(cols.reshape(2, b, m, nb, b), (2, 3, 4, 1, 0))
    kpar = (jnp.arange(nb) % 2)[None, :, None, None]
    return jnp.where(kpar == 0, pk[..., 0], pk[..., 1])


def block_jacobi_precond(f: Callable, x, block: int) -> Callable:
    """Right-preconditioner v ↦ M⁻¹v from J's diagonal blocks at ``x``.

    f: [M, N] -> [M, N]; N must be divisible by ``block``. Costs ``block``
    jvp's to build + one batched LU of [M·nb, b, b]; each application is two
    batched triangular sweeps (pure elementwise work). Exact when J is block
    diagonal w.r.t. the partition; the standard colored approximation
    otherwise.
    """
    m, n = x.shape
    if n % block != 0:
        raise ValueError(f"N={n} not divisible by block={block}")
    nb = n // block
    cols = probe_colored_jacobian(f, x, block)                 # [b, M, N]
    # blocks[m, k, r, c] = (J v_c)[m, k*b + r]
    blocks = jnp.transpose(cols.reshape(block, m, nb, block),
                           (1, 2, 3, 0))                       # [M, nb, b, b]
    lu, piv = lu_factor(blocks)
    # guard singular blocks: fall back to identity on that block
    diag = jnp.abs(jnp.diagonal(lu, axis1=-2, axis2=-1))
    bad = (jnp.min(diag, axis=-1) <= 0.0) | \
        ~jnp.all(jnp.isfinite(lu), axis=(-2, -1))              # [M, nb]
    eye = jnp.broadcast_to(jnp.eye(block, dtype=x.dtype), lu.shape)
    lu = jnp.where(bad[..., None, None], eye, lu)
    piv = jnp.where(bad[..., None], jnp.arange(block, dtype=piv.dtype), piv)

    def apply(v):
        vb = v.reshape(m, nb, block)
        out = lu_solve(lu, piv, vb)
        return out.reshape(m, n)

    return apply


def tridiag_solve(dl, d, du, b):
    """Batched Thomas algorithm: solve T x = b with T tridiagonal.

    dl/d/du/b: [..., N] (dl[..., 0] and du[..., -1] ignored). Sequential in
    N via two `lax.scan` sweeps whose steps are [...]-vectorized over the
    batch. No pivoting (preconditioner use).
    """
    def safe(x):
        return jnp.where(x == 0.0, jnp.ones_like(x), x)

    # forward sweep: cp[i] = du[i]/(d[i]-dl[i]*cp[i-1]), dp likewise
    def fwd(carry, inp):
        cp_prev, dp_prev = carry
        dli, di, dui, bi = inp
        denom = safe(di - dli * cp_prev)
        cp = dui / denom
        dp = (bi - dli * dp_prev) / denom
        return (cp, dp), (cp, dp)

    batch = d.shape[:-1]
    z = jnp.zeros(batch, d.dtype)
    inp = tuple(jnp.moveaxis(a, -1, 0) for a in (dl, d, du, b))
    _, (cps, dps) = jax.lax.scan(fwd, (z, z), inp)

    # back substitution: x[i] = dp[i] - cp[i] * x[i+1]
    def bwd(x_next, inp):
        cpi, dpi = inp
        x = dpi - cpi * x_next
        return x, x

    _, xs = jax.lax.scan(bwd, z, (cps, dps), reverse=True)
    return jnp.moveaxis(xs, 0, -1)


def tridiag_bands(f: Callable, x):
    """The three diagonals (dl, d, du) of J at ``x`` from 3 colored jvp's.

    f: [M, N] -> [M, N]. Exact for tridiagonal J (1-D 3-point stencils);
    colored (folded) approximation otherwise. dl[...,0] and du[...,-1] are 0.
    """
    m, n = x.shape
    nc = min(3, n)
    cols = probe_colored_jacobian(f, x, nc)                    # [nc, M, N]
    idx = jnp.arange(n)
    pick = jnp.moveaxis(cols, 0, -1)                           # [M, N, nc]

    def diag_at(offset):
        # entry J[i, i+offset] lives in color (i+offset) % nc at row i
        j = idx + offset
        onehot = (j[:, None] % nc == jnp.arange(nc)[None, :]) & \
            (j[:, None] >= 0) & (j[:, None] < n)
        return jnp.sum(jnp.where(onehot[None], pick, 0.0), axis=-1)

    return diag_at(-1), diag_at(0), diag_at(1)


def tridiag_precond(f: Callable, x) -> Callable:
    """Right-preconditioner from J's tridiagonal part at ``x`` (3 colored
    jvp's + Thomas sweeps). Exact for tridiagonal J (1-D 3-point stencils);
    colored approximation otherwise."""
    dl, dmain, du = tridiag_bands(f, x)
    bad = ~jnp.all(jnp.isfinite(dmain) & (dmain != 0.0), axis=-1,
                   keepdims=True)
    dmain = jnp.where(bad, jnp.ones_like(dmain), dmain)
    dl = jnp.where(bad, jnp.zeros_like(dl), dl)
    du = jnp.where(bad, jnp.zeros_like(du), du)

    def apply(v):
        return tridiag_solve(dl, dmain, du, v)

    return apply
