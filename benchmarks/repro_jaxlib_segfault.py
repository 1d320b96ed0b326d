"""Minimal repro attempt for the jaxlib CPU-compiler segfault that
``tests/conftest.py`` works around.

Symptom: with the full test suite in ONE process (~400 compiled programs,
no cache clearing), jaxlib 0.9.0's CPU compiler segfaults inside
``backend_compile`` around the 150th test, regardless of which test runs
there. ``jax.clear_caches()`` between modules avoids it.

This script compiles N distinct programs (unique shapes force fresh
compilations) without clearing caches. Run:

    python benchmarks/repro_jaxlib_segfault.py 500

Exit code 0 = no segfault at this count; a segfault kills the process with
SIGSEGV (rc -11 / 139).
"""

import sys

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def main(n):
    import numpy as np

    for i in range(n):
        d = 3 + (i % 97)  # unique-ish shapes → genuinely new executables
        m = 2 + (i % 13)

        def f(x, y, _i=i):
            # moderately complex program: scan + linalg, like the suite's
            z = x @ y
            c = jnp.linalg.cholesky(z @ z.T + jnp.eye(z.shape[0]) * (_i + 1))

            def step(carry, t):
                return carry + jnp.tanh(c @ carry) * 1e-3, t

            out, _ = jax.lax.scan(step, x[:, 0], jnp.arange(5))
            return jnp.sum(out) + jnp.sum(c)

        x = jnp.asarray(np.random.default_rng(i).standard_normal((d, m)))
        y = jnp.asarray(np.random.default_rng(i + 1).standard_normal((m, d)))
        val = jax.jit(f)(x, y)
        val.block_until_ready()
        if (i + 1) % 50 == 0:
            print(f"{i + 1} programs compiled OK", flush=True)
    print(f"no segfault after {n} compiled programs")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 500)
