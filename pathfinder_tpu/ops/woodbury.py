"""Low-rank-plus-PD ("Woodbury") positive-definite matrices.

Re-implements the capability surface of the reference's ``WoodburyPDMat`` /
``pdfactorize`` (reference: ``src/woodbury.jl:1-436``) with a factorization
designed for XLA instead of a translation:

The reference factors ``W = A + B D Bᵀ`` as ``W = Lᵀ L`` via a *tall* QR
decomposition of ``U⁻ᵀ B`` whose implicit full ``n×n`` orthogonal factor is
applied lazily (``src/woodbury.jl:174-207``). A full orthogonal apply is
hostile to XLA (no lazy Householder apply, dynamic shapes); instead we use the
algebraically equivalent QR-free square root

    W = A½ (I + X C Xᵀ) (I + X Cᵀ Xᵀ) A½,      X = A^{-1/2} B  (n×m)

with the small ``m×m`` core computed from one ``m×m`` symmetric
eigendecomposition plus one ``m×m`` Cholesky:

    G = Xᵀ X = E Λ Eᵀ           (eigh; rank-revealing)
    Λ̃ = Λ on active dims (λ > tol·λmax), 1 elsewhere
    M = I + Λ̃½ (Eᵀ D E ∘ active) Λ̃½,   V = chol(M)  (lower, M = V Vᵀ)
    C  = E Λ̃^{-1/2} (V   − I) Λ̃^{-1/2} Eᵀ
    Ci = E Λ̃^{-1/2} (V⁻¹ − I) Λ̃^{-1/2} Eᵀ          (gives L⁻¹)

so that ``L = A½ (I + X C Xᵀ)`` satisfies ``L Lᵀ = W`` exactly on the range
of ``X`` (proof: C + Cᵀ + C G Cᵀ equals ``D`` projected onto range(Xᵀ), and
``X`` annihilates the complement). Every operation is then O(n·m) matvecs /
O(n·m²) matmuls plus O(m³) small-matrix work; nothing ``n×n`` is
ever materialized (for diagonal ``A``). ``logdet W = logdet A + 2 Σ log
diag(V)`` by the matrix determinant lemma.

The rank-revealing eigendecomposition makes the factorization total: it
uniformly handles m > n (more low-rank columns than dimensions), masked
columns (zeroed ``B`` columns from fixed-shape L-BFGS history windows that
are not yet full — replacing the reference's variable-sized history matrices,
``src/inverse_hessian.jl:49-52``, as XLA requires), and numerically collinear
history, all without data-dependent shapes.

Operator parity with the reference (``src/woodbury.jl:289-436``): dense
materialization, matmul, solve, logdet/det, diag, inv (still in Woodbury
form), quad/invquad, whiten/unwhiten, positive-scalar multiply, and left /
right factor applications L·x, Lᵀ·x, L⁻¹·x, L⁻ᵀ·x (the reference's ``R``
factor is our ``Lᵀ``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import block_diag, solve_triangular

_HIGHEST = jax.lax.Precision.HIGHEST


def matmul(a, b):
    """``a @ b`` at the full precision of the dtype. Every matrix product
    of the Woodbury and L-BFGS algebra goes through here: the compact
    L-BFGS factors hold large entries of both signs whose products cancel,
    and a GPU's default float32 matmul rounds its inputs to TF32's 10-bit
    mantissa — at d=1000 that put a relative error of 0.9 on ``A + B D Bᵀ``
    of an L-BFGS inverse Hessian, where full float32 leaves 2e-4."""
    return jnp.matmul(a, b, precision=_HIGHEST)

def _concrete_scalar(c):
    """``float(c)`` when ``c`` is a concrete scalar — Python int/float,
    numpy scalar, or an untraced 0-d array — else ``None`` (traced
    values cannot change the output type)."""
    if isinstance(c, jax.core.Tracer):
        return None
    try:
        return float(c)
    except (TypeError, ValueError):
        return None


__all__ = [
    "WoodburyFactor",
    "WoodburyPDMat",
    "pdfactorize",
    "pdunfactorize",
]


def _tree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    return jax.tree_util.register_dataclass(cls)


@_tree_dataclass
class WoodburyFactor:
    """Square-root factorization of a Woodbury PD matrix: ``W = L Lᵀ``.

    ``L = A½ (I + X C Xᵀ)`` with ``X = A^{-1/2} B``. For diagonal ``A``,
    ``a_half`` has shape ``(n,)`` and is ``sqrt(diag A)``; for dense ``A`` it
    is the *lower* Cholesky factor ``Kₐ`` with ``A = Kₐ Kₐᵀ`` (so ``A½ x``
    means ``Kₐ x``). Parity target: ``WoodburyPDFactorization``
    (``src/woodbury.jl:12-80``); our ``L``/``R=Lᵀ`` play the same role as the
    reference's ``F.L``/``F.R`` (they differ by an orthogonal rotation, which
    no consumer observes).
    """

    a_half: jax.Array  # (n,) sqrt-diag  or  (n, n) lower Cholesky of A
    X: jax.Array  # (n, m) = A^{-1/2} B (with masked columns zeroed)
    C: jax.Array  # (m, m) core of L
    Ci: jax.Array  # (m, m) core of L⁻¹
    log_det: jax.Array  # () log det W

    @property
    def diag_A(self) -> bool:
        return self.a_half.ndim == 1

    @property
    def dim(self) -> int:
        return self.a_half.shape[0]

    # -- A^{±1/2} applications ------------------------------------------------
    def _ah_mul(self, x):
        if self.diag_A:
            return x * _colvec(self.a_half, x)
        return matmul(self.a_half, x)  # (n,) and (n, N) both


    def _ah_t_mul(self, x):
        if self.diag_A:
            return x * _colvec(self.a_half, x)
        return matmul(self.a_half.T, x)

    def _ah_solve(self, x):
        if self.diag_A:
            return x / _colvec(self.a_half, x)
        return solve_triangular(self.a_half, x, lower=True)

    def _ah_t_solve(self, x):
        if self.diag_A:
            return x / _colvec(self.a_half, x)
        return solve_triangular(self.a_half, x, lower=True, trans=1)

    def _core(self, M, x):
        # x + X @ (M @ (Xᵀ x)), batched over trailing dims of x
        return x + matmul(self.X, matmul(M, matmul(self.X.T, x)))

    # -- factor applications --------------------------------------------------
    def L_mul(self, x):
        """``L x`` (reference ``lmul!(F.L, x)``, ``src/woodbury.jl:145-151``)."""
        return self._ah_mul(self._core(self.C, x))

    def Lt_mul(self, x):
        """``Lᵀ x`` — the reference's right factor ``R x``."""
        return self._core(self.C.T, self._ah_t_mul(x))

    def L_solve(self, x):
        """``L⁻¹ x`` (reference ``ldiv!(F.L, x)``, ``src/woodbury.jl:162-168``)."""
        return self._core(self.Ci, self._ah_solve(x))

    def Lt_solve(self, x):
        """``L⁻ᵀ x`` — the reference's ``ldiv!(F.R, x)``."""
        return self._ah_t_solve(self._core(self.Ci.T, x))

    def mul(self, x):
        """``W x = L (Lᵀ x)``."""
        return self.L_mul(self.Lt_mul(x))

    def solve(self, x):
        """``W⁻¹ x = L⁻ᵀ (L⁻¹ x)`` (reference ``ldiv!(F, x)``)."""
        return self.Lt_solve(self.L_solve(x))

    def dense_L(self):
        return self.L_mul(jnp.eye(self.dim, dtype=self.X.dtype))

    def dense_R(self):
        return self.dense_L().T

    def logabsdet(self):
        return self.log_det, jnp.ones_like(self.log_det)


def _colvec(v, x):
    """Broadcast a length-n vector against (n,) or (n, N) arrays."""
    return v if x.ndim == 1 else v[:, None]


def pdfactorize(
    A: jax.Array,
    B: jax.Array,
    D: jax.Array,
    col_mask: Optional[jax.Array] = None,
    method: str = "chol",
) -> WoodburyFactor:
    """Factorize ``W = A + B D Bᵀ`` (parity: ``pdfactorize``, ``src/woodbury.jl:201-207``).

    ``A`` may be a diagonal given as shape ``(n,)`` or a dense PD ``(n, n)``
    matrix. ``col_mask`` (shape ``(m,)``, values 0/1) marks active columns of
    ``B``; masked columns are treated as absent (the enabling trick for fixed
    shape L-BFGS history windows under ``vmap``/``scan``).

    ``method``:

    * ``"chol"`` (default, the hot path): ridge-regularized Cholesky of
      the Gram matrix, ``G̃ = XᵀX + δI``. Rank-deficient directions (masked
      columns, m > n, duplicated history) lie in the null space of ``X``, so
      the ridge's effect on the represented ``W`` is O(δ) — ``X`` annihilates
      exactly the directions the ridge perturbs. Two small Cholesky solves;
      no eigendecomposition.
    * ``"eigh"``: rank-revealing symmetric eigendecomposition with exact
      projection of null directions — maximally robust, at the cost of a
      batched ``eigh`` of the small cores.
    """
    if B.ndim != 2 or D.ndim != 2 or D.shape != (B.shape[1],) * 2:
        # a 1-D B would silently broadcast into an (n, n) X and factor a
        # completely different matrix (the natural rank-1 calling mistake)
        raise ValueError(
            f"B must be (n, m) and D (m, m); got B {B.shape}, D {D.shape}"
        )
    dtype = jnp.result_type(A, B, D)
    A, B, D = A.astype(dtype), B.astype(dtype), D.astype(dtype)
    m = B.shape[-1]
    if col_mask is not None:
        col_mask = jnp.asarray(col_mask).astype(dtype)
        B = B * col_mask
        D = D * col_mask[:, None] * col_mask[None, :]

    if A.ndim == 1:
        a_half = jnp.sqrt(A)
        X = B / a_half[:, None] if m else jnp.zeros_like(B)
        log_det_A = jnp.sum(jnp.log(A))
    else:
        a_half = jnp.linalg.cholesky(A)  # lower, A = Kₐ Kₐᵀ
        X = solve_triangular(a_half, B, lower=True) if m else jnp.zeros_like(B)
        log_det_A = 2.0 * jnp.sum(jnp.log(jnp.diagonal(a_half)))

    if m == 0:
        eye0 = jnp.zeros((0, 0), dtype)
        return WoodburyFactor(a_half, X, eye0, eye0, log_det_A)

    eps = jnp.finfo(dtype).eps
    eye = jnp.eye(m, dtype=dtype)
    G = matmul(X.T, X)
    # the regularization scale must come from the DATA Gram, measured
    # before any masked-column identity injection: an absolute floor (or
    # the injected unit diagonal) makes the ridge/rank tolerance dwarf a
    # small-but-well-conditioned Gram — near convergence the L-BFGS steps
    # shrink, diag(G) ~ |s|²/α can sit far below 1 while D ~ 1/(sᵀy)
    # grows inversely, and an absolute ridge then drives I + KᵀDK
    # indefinite (NaN factorization for a perfectly fine W). With the
    # data-relative scale the ridge stays O(eps) *of the data*.
    scale = jnp.max(jnp.diagonal(G))  # m == 0 returned above
    scale = jnp.where(scale > 0, scale, 1.0)
    if col_mask is not None:
        # masked columns get an identity block AT THE DATA SCALE so they
        # neither pollute the scale estimate nor skew chol conditioning
        G = G + eye * (1.0 - col_mask) * scale

    if method == "chol":
        ridge = (32 * m * eps) * scale
        K = jnp.linalg.cholesky(G + ridge * eye)  # lower, G̃ = K Kᵀ, R = Kᵀ
        M = eye + matmul(matmul(K.T, D), K)  # I + R D Rᵀ
        V = jnp.linalg.cholesky(M)  # lower, M = V Vᵀ
        V_inv = solve_triangular(V, eye, lower=True)

        def core(T):  # K⁻ᵀ T K⁻¹
            P = solve_triangular(K, T, lower=True, trans=1)
            return solve_triangular(K, P.T, lower=True, trans=1).T

        C = core(V - eye)
        Ci = core(V_inv - eye)
    elif method == "eigh":
        lam, E = jnp.linalg.eigh(G)  # ascending eigenvalues
        tol = scale * (32 * m * eps)
        active = (lam > tol).astype(dtype)
        lam_t = jnp.where(active > 0, lam, 1.0)
        s = jnp.sqrt(lam_t)  # Λ̃^{1/2}
        D_E = matmul(matmul(E.T, D), E) * (active[:, None] * active[None, :])
        M = eye + (s[:, None] * D_E) * s[None, :]
        V = jnp.linalg.cholesky(M)  # lower, M = V Vᵀ
        V_inv = solve_triangular(V, eye, lower=True)
        inv_ss = 1.0 / (s[:, None] * s[None, :])
        C = matmul(matmul(E, (V - eye) * inv_ss), E.T)
        Ci = matmul(matmul(E, (V_inv - eye) * inv_ss), E.T)
    else:
        raise ValueError(f"unknown factorization method {method!r}")

    log_det = log_det_A + 2.0 * jnp.sum(jnp.log(jnp.diagonal(V)))
    return WoodburyFactor(a_half, X, C, Ci, log_det)


def pdunfactorize(F: WoodburyFactor):
    """Recover ``(A, B, D)`` producing the same ``W`` (parity:
    ``pdunfactorize``, ``src/woodbury.jl:218-223``)."""
    if F.diag_A:
        A = F.a_half**2
        B = F.a_half[:, None] * F.X
    else:
        A = matmul(F.a_half, F.a_half.T)
        B = matmul(F.a_half, F.X)
    G = matmul(F.X.T, F.X)
    D = F.C + F.C.T + matmul(matmul(F.C, G), F.C.T)
    return A, B, D


@_tree_dataclass
class WoodburyPDMat:
    """Lazy ``n×n`` PD matrix ``W = A + B D Bᵀ`` (parity: ``WoodburyPDMat``,
    ``src/woodbury.jl:226-436``).

    A registered pytree: safe to ``jit``/``vmap``/``scan`` over. ``A`` is
    stored as shape ``(n,)`` (diagonal, the hot path — the L-BFGS H₀ is always
    diagonal, ``src/inverse_hessian.jl:38-39``) or ``(n, n)`` dense.
    """

    A: jax.Array  # (n,) diagonal or (n, n) dense
    B: jax.Array  # (n, m)
    D: jax.Array  # (m, m)
    factor: WoodburyFactor

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def from_parts(A, B, D, col_mask=None, method="chol") -> "WoodburyPDMat":
        # store A/B/D in the promoted dtype the factor is computed in —
        # mixed-precision parts would otherwise make a pytree with
        # inconsistent leaf dtypes and a .dtype property (B's) that
        # disagrees with the factor's
        dtype = jnp.result_type(A, B, D)
        A = jnp.asarray(A, dtype)
        B = jnp.asarray(B, dtype)
        D = jnp.asarray(D, dtype)
        F = pdfactorize(A, B, D, col_mask=col_mask, method=method)
        if col_mask is not None:
            cm = jnp.asarray(col_mask).astype(dtype)
            B = B * cm
            D = D * cm[:, None] * cm[None, :]
        return WoodburyPDMat(A, B, D, F)

    # -- basic properties -----------------------------------------------------
    @property
    def dim(self) -> int:
        return self.A.shape[0]

    @property
    def shape(self):
        return (self.dim, self.dim)

    @property
    def dtype(self):
        return self.B.dtype

    def to_dense(self) -> jax.Array:
        """Materialize ``A + B D Bᵀ`` (parity: ``Matrix``, ``src/woodbury.jl:289``)."""
        Ad = jnp.diag(self.A) if self.A.ndim == 1 else self.A
        return Ad + matmul(matmul(self.B, self.D), self.B.T)

    def diag(self) -> jax.Array:
        """Diagonal of ``W`` (parity: ``diag``, ``src/woodbury.jl:326-329``)."""
        a = self.A if self.A.ndim == 1 else jnp.diagonal(self.A)
        return a + jnp.einsum(
            "im,mk,ik->i", self.B, self.D, self.B, precision=_HIGHEST
        )

    # -- linear algebra -------------------------------------------------------
    def mul(self, x) -> jax.Array:
        """``W x`` for ``x`` of shape ``(n,)`` or ``(n, N)``."""
        Ax = x * _colvec(self.A, x) if self.A.ndim == 1 else matmul(self.A, x)
        return Ax + matmul(self.B, matmul(self.D, matmul(self.B.T, x)))

    __matmul__ = mul

    def solve(self, x) -> jax.Array:
        return self.factor.solve(x)

    def logdet(self) -> jax.Array:
        return self.factor.log_det

    def logabsdet(self):
        return self.factor.logabsdet()

    def det(self) -> jax.Array:
        return jnp.exp(self.factor.log_det)

    def inv(self, method: str = "chol") -> "WoodburyPDMat":
        """``W⁻¹``, still in Woodbury form (parity: ``inv``, ``src/woodbury.jl:317-321``).

        ``W⁻¹ = A⁻¹ + (A⁻¹B) D' (A⁻¹B)ᵀ`` with ``D' = Ci + Ciᵀ + Ciᵀ G Ci``.
        ``method`` selects the refactorization path of the result (a matrix
        built with ``method="eigh"`` for robustness should pass it here
        too — derived objects do not remember how they were factorized).
        """
        F = self.factor
        G = matmul(F.X.T, F.X)
        D_inv = F.Ci + F.Ci.T + matmul(matmul(F.Ci.T, G), F.Ci)
        if F.diag_A:
            A_inv = 1.0 / self.A
            B_inv = F.X / F.a_half[:, None]
        else:
            eye = jnp.eye(self.dim, dtype=self.dtype)
            ah_inv = solve_triangular(F.a_half, eye, lower=True)
            A_inv = matmul(ah_inv.T, ah_inv)
            B_inv = matmul(ah_inv.T, F.X)
        return WoodburyPDMat.from_parts(A_inv, B_inv, D_inv, method=method)

    def quad(self, x) -> jax.Array:
        """``xᵀ W x`` columnwise (parity: ``PDMats.quad``, ``src/woodbury.jl:388-397``)."""
        Bx = matmul(self.B.T, x)
        if self.A.ndim == 1:
            ax = jnp.sum(x * x * _colvec(self.A, x), axis=0)
        else:
            ax = jnp.sum(x * matmul(self.A, x), axis=0)
        return ax + jnp.sum(Bx * matmul(self.D, Bx), axis=0)

    def invquad(self, x) -> jax.Array:
        """``xᵀ W⁻¹ x`` columnwise (parity: ``PDMats.invquad``, ``src/woodbury.jl:369-376``)."""
        v = self.factor.L_solve(x)
        return jnp.sum(v * v, axis=0)

    def whiten(self, x) -> jax.Array:
        """``L⁻¹ x`` (parity: ``PDMats.whiten``, ``src/woodbury.jl:408``)."""
        return self.factor.L_solve(x)

    def unwhiten(self, x) -> jax.Array:
        """``L x`` (parity: ``PDMats.unwhiten``, ``src/woodbury.jl:399``)."""
        return self.factor.L_mul(x)

    def inv_unwhiten(self, x) -> jax.Array:
        """``R⁻¹ x = L⁻ᵀ x`` (parity: ``PDMats.invunwhiten!``, ``src/woodbury.jl:417-422``)."""
        return self.factor.Lt_solve(x)

    def astype(self, dtype, method: str = "chol") -> "WoodburyPDMat":
        """Convert element type, refactorizing in the target precision
        (parity: ``convert(WoodburyPDMat{T}, ...)``, ``src/woodbury.jl:
        273-283``). ``method``: refactorization path of the result."""
        return WoodburyPDMat.from_parts(
            self.A.astype(dtype), self.B.astype(dtype), self.D.astype(dtype),
            method=method,
        )

    def entry(self, i, j) -> jax.Array:
        """Single element ``W[i, j]`` without densifying (parity:
        ``getindex``, ``src/woodbury.jl:306-311``)."""
        if self.A.ndim == 1:
            a = jnp.where(i == j, self.A[i], 0.0)
        else:
            a = self.A[i, j]
        return a + matmul(self.B[i], matmul(self.D, self.B[j]))

    def add_scaled_identity(self, c, method: str = "chol") -> "WoodburyPDMat":
        """``W + c·I`` keeping Woodbury form (parity: ``+(::WoodburyPDMat,
        ::UniformScaling)``, ``src/woodbury.jl:333-338`` — the reference
        routes through ``PDMats.ScalMat``; here ``A + c·I`` stays diagonal /
        dense directly). ``c`` must keep ``A + c·I`` positive definite.
        ``method``: refactorization path of the result."""
        if self.A.ndim == 1:
            A = self.A + c
        else:
            A = self.A + c * jnp.eye(self.dim, dtype=self.dtype)
        return WoodburyPDMat.from_parts(A, self.B, self.D, method=method)

    def __add__(self, other):
        return self.add(other)

    def add(self, other, method: str = "chol") -> "WoodburyPDMat":
        """``W₁ + W₂`` in lazy form (``__add__`` with a selectable
        refactorization ``method`` — every other derived-object
        constructor exposes it; near-collinear concatenated columns are
        exactly the case ``method="eigh"`` exists for)."""
        if isinstance(other, WoodburyPDMat):
            # A₁+A₂ stays diag/dense; the low-rank parts concatenate
            if (self.A.ndim == 1) == (other.A.ndim == 1):
                A = self.A + other.A
            else:
                a1 = jnp.diag(self.A) if self.A.ndim == 1 else self.A
                a2 = jnp.diag(other.A) if other.A.ndim == 1 else other.A
                A = a1 + a2
            B = jnp.concatenate([self.B, other.B], axis=1)
            D = block_diag(self.D, other.D)  # promotes dtypes correctly
            return WoodburyPDMat.from_parts(A, B, D, method=method)
        return NotImplemented

    __radd__ = __add__

    def scale(self, c, method: str = "chol"):
        """``W * c``: positive scalar ``c`` keeps Woodbury form; a concrete
        non-positive ``c`` returns the dense array ``c * to_dense()`` —
        full parity with the reference (``*``, ``src/woodbury.jl:357-360``),
        which also falls back to a plain matrix there (the result is no
        longer positive definite, so no lazy form exists). A *traced*
        non-positive ``c`` cannot change the output type and yields NaNs
        (detectable via ``is_finite_pd``)."""
        cv = _concrete_scalar(c)
        if cv is not None and cv <= 0:
            return cv * self.to_dense()
        return WoodburyPDMat.from_parts(
            self.A * c, self.B, self.D * c, method=method
        )

    def __mul__(self, c):
        return self.scale(c)

    __rmul__ = __mul__

    def is_finite_pd(self) -> jax.Array:
        """True when the factorization succeeded (W numerically PD).

        The reference construction *throws* ``PosDefException``
        (``src/woodbury.jl:253-257`` via Cholesky); in JAX a failed Cholesky
        yields NaNs, which this predicate detects jit-safely.
        """
        leaves = [self.factor.C, self.factor.Ci, self.factor.log_det]
        return jnp.all(
            jnp.array([jnp.all(jnp.isfinite(leaf)) for leaf in leaves])
        )
