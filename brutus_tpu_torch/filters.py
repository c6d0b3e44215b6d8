"""
Registry of photometric bands supported by the stock model grids.

Parity: reference `brutus/filters.py:13-29` defines the same 49 bands in
the same order (the order defines the filter axis of every grid file).
"""

gaia = ["Gaia_G_MAW", "Gaia_BP_MAWf", "Gaia_RP_MAW"]
sdss = ["SDSS_{}".format(b) for b in "ugriz"]
ps = ["PS_{}".format(b) for b in ["g", "r", "i", "z", "y", "w", "open"]]
decam = ["DECam_{}".format(b) for b in "ugrizY"]
tycho = ["Tycho_B", "Tycho_V"]
bessell = ["Bessell_{}".format(b) for b in "UBVRI"]
tmass = ["2MASS_{}".format(b) for b in ["J", "H", "Ks"]]
ukidss = ["UKIDSS_{}".format(b) for b in "ZYJHK"]
vista = ["VISTA_{}".format(b) for b in ["Z", "Y", "J", "H", "Ks"]]
wise = ["WISE_W{}".format(b) for b in "1234"]
hipp = ["Hipparcos_Hp"]
kepler = ["Kepler_D51", "Kepler_Kp"]
tess = ["TESS"]

FILTERS = (gaia + sdss + ps + decam + bessell +
           tmass + vista + ukidss + wise +
           tycho + hipp + kepler + tess)


def filter_indices(filters):
    """Map an iterable of filter names to indices into ``FILTERS``."""
    return [FILTERS.index(f) for f in filters]


__all__ = ["FILTERS", "filter_indices"]
