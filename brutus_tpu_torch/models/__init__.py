"""Grid generation (mirrors `brutus_tpu/models`): the bolometric-
correction networks, the MIST track and isochrone interpolators and the
SED grid generator.  Importing the package needs no h5py: only the file
readers and writers import it."""

from .nn import FastNN, FastNNPredictor  # noqa: F401
from .tracks import MISTtracks  # noqa: F401
from .sedmaker import SEDmaker  # noqa: F401
from .isochrone import Isochrone  # noqa: F401
