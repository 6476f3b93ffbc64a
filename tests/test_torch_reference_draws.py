"""chip_smoke.reference_ransac_draws gives the JAX package's bootstrap RANSAC
draws without JAX, so that the smoke's depth-12 soak on the card starts from
the reference's bootstrap: it must equal jax.random.randint(PRNGKey(seed),
(n_hyp, 4), 0, n_valid) exactly, for the counts a bootstrap sees and past
the 16-bit range of randint's modular reduction."""
import jax
import numpy as np
import pytest

import chip_smoke


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n_valid", [1, 2, 7, 97, 150, 255, 1000, 70000])
def test_reference_draws_equal_jax(seed, n_valid):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (256, 4),
                                         0, n_valid))
    got = chip_smoke.reference_ransac_draws(n_valid, 256, seed=seed)
    assert got.shape == (256, 4) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
