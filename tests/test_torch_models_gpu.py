"""Grid generation and the cluster likelihood on a CUDA card against the
port on the CPU, at small size.  Every test here carries the `gpu`
marker and skips where no card is present (the check runs inside each
test, never at import).

The module imports no jax and no h5py (the tables are built in memory by
`chip_smoke.py`'s builders), so it runs on a card machine without them:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_models_gpu.py
"""

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from brutus_tpu_torch.cluster import isochrone_loglike

pytestmark = pytest.mark.gpu
CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_make_grid_on_the_card_matches_the_cpu(cuda):
    """`make_grid` on the card (float64, chunks of 1000, binaries of smf
    0.5 included) against the CPU: the same labels, validity and NaN
    pattern, coefficients and predictions within 1e-8."""
    library = smoke.synth_library(True)
    kw = dict(smoke.grid_kwargs(True), chunk=1000,
              smf_grid=np.array([0.0, 0.5]))
    card, host = smoke.synth_maker(library, cuda), smoke.synth_maker(
        library, CPU)
    card.make_grid(**kw)
    host.make_grid(**kw)
    np.testing.assert_array_equal(card.grid_sel, host.grid_sel)
    assert (card.grid_sel & (card.grid_label["smf"] == 0.5)).any()
    for a, b, names in ((card.grid_sed, host.grid_sed, card.filters),
                        (card.grid_param, host.grid_param,
                         card.predictions)):
        for n in names:
            np.testing.assert_array_equal(np.isnan(a[n]), np.isnan(b[n]))
            np.testing.assert_allclose(a[n], b[n], rtol=0, atol=1e-8,
                                       equal_nan=True)


def test_isochrone_loglike_on_the_card_matches_the_cpu(cuda):
    """`isochrone_loglike` of a small cluster on the card against the CPU
    in float64 at phase 12's seeded thetas: relative deviation at most
    1e-9."""
    arrays = smoke.synth_isochrone_arrays(True)
    card = smoke.synth_isochrone(arrays, cuda)
    host = smoke.synth_isochrone(arrays, CPU)
    data = smoke.synth_cluster(host, 60)
    kw = dict(parallax=data["parallax"], parallax_err=data["parallax_err"],
              eep_grid=np.linspace(202.0, 808.0, 400))
    for th in smoke.cluster_thetas(8):
        a = isochrone_loglike(th, card, data["phot"], data["err"],
                              device=cuda, **kw)
        b = isochrone_loglike(th, host, data["phot"], data["err"],
                              device=CPU, **kw)
        assert abs(a - b) <= 1e-9 * abs(b), (th, a, b)
