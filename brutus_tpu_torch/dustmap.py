"""
3-D dust map backends (host-side lookup, device-side interpolation).

Parity: reference `brutus/dust.py` (`DustMap`, `Bayestar`).  The
Bayestar19 map stores, per multi-resolution HEALPix sky pixel, a
line-of-sight profile of mean/std A(V) on a fixed distance ladder.
The lookup (sky pixel -> profile) is a host-side gather performed once
per star batch at setup time; the per-draw interpolation onto sampled
distances happens on device (`priors.dust_lnprior` and the MC kernel).
The port's own copy: h5py is imported only where a map file is read or
written, so the fitting path runs where h5py is absent.
"""

import numpy as np

from .healpix import lb2pix


class DustMap:
    """Base class for 3-D dust maps (reference `brutus/dust.py:71-95`)."""

    def __call__(self, *args, **kwargs):
        return self.query(*args, **kwargs)

    def query(self, *args, **kwargs):
        raise NotImplementedError


class Bayestar(DustMap):
    """Bayestar-style multi-resolution HEALPix 3-D dust map.

    Parity: reference `brutus/dust.py:184-299`.  File schema:
    `pixel_info` (structured, fields `nside` + `healpix_index`),
    `dists` (Ndist,), `av_mean` / `av_std` (Npix, Ndist).
    """

    def __init__(self, dustfile="bayestar2019_v1.h5"):
        import h5py
        try:
            f = h5py.File(dustfile, "r", libver="latest", swmr=True)
        except (OSError, ValueError):
            f = h5py.File(dustfile, "r")
        with f:
            self._pixel_info = f["pixel_info"][:]
            self._distances = np.asarray(f["dists"][:], dtype=np.float64)
            self._av_mean = np.asarray(f["av_mean"][:], dtype=np.float32)
            self._av_std = np.asarray(f["av_std"][:], dtype=np.float32)
        self._n_distances = len(self._distances)
        self._n_pix = self._pixel_info.size

        # Per-nside sorted indices for O(log N) pixel lookup
        # (reference brutus/dust.py:216-229).
        order = np.argsort(self._pixel_info,
                           order=["nside", "healpix_index"])
        self._nside_levels = np.unique(self._pixel_info["nside"])
        self._hp_idx_sorted = []
        self._data_idx = []
        lo = 0
        for nside in self._nside_levels:
            hi = np.searchsorted(self._pixel_info["nside"], nside,
                                 side="right", sorter=order)
            idx = order[lo:hi]
            self._hp_idx_sorted.append(self._pixel_info["healpix_index"][idx])
            self._data_idx.append(idx)
            lo = hi

    def _find_data_idx(self, l, b):
        """Data row for each `(l, b)`; -1 where uncovered.

        Parity: reference `brutus/dust.py:231-265` (multi-nside
        searchsorted; finer levels override coarser ones).
        """
        l = np.atleast_1d(l)
        b = np.atleast_1d(b)
        out = np.full(l.shape, -1, dtype=np.int64)
        for k, nside in enumerate(self._nside_levels):
            ipix = lb2pix(int(nside), l, b, nest=True)
            hp_sorted = self._hp_idx_sorted[k]
            pos = np.searchsorted(hp_sorted, ipix, side="left")
            ok = pos < hp_sorted.size
            pos_c = np.clip(pos, 0, hp_sorted.size - 1)
            hit = ok & (hp_sorted[pos_c] == ipix) & (ipix >= 0)
            out[hit] = self._data_idx[k][pos_c[hit]]
        return out

    def get_query_size(self, l, b):
        return np.prod(np.shape(l), dtype=int) * self._n_distances

    def query(self, coord):
        """LOS profile for galactic `(l, b)` (degrees).

        Parameters
        ----------
        coord : tuple of `(l, b)` scalars or arrays.

        Returns
        -------
        dists : (Ndist,) distance ladder (kpc).
        av_mean, av_std : (..., Ndist) profiles; NaN where uncovered.
        """
        l, b = np.atleast_1d(coord[0]), np.atleast_1d(coord[1])
        idx = self._find_data_idx(l, b)
        good = idx >= 0
        avm = self._av_mean[np.clip(idx, 0, self._n_pix - 1)].astype(float)
        avs = self._av_std[np.clip(idx, 0, self._n_pix - 1)].astype(float)
        avm[~good] = np.nan
        avs[~good] = np.nan
        if avm.shape[0] == 1:
            avm, avs = avm[0], avs[0]
        return self._distances, avm, avs


def uniform_profile(av_dist, av_mean, av_std, n=256):
    """Resample LOS profiles onto a uniform distance ladder.

    The Bayestar ladder is uniform in distance modulus; the device-side
    `priors.dust_lnprior` requires a uniform-in-distance ladder so the
    interpolation index is pure arithmetic (no searchsorted, which
    dominates posterior-stage runtime on TPU).

    Parameters
    ----------
    av_dist : (Ndist,); av_mean, av_std : (..., Ndist)

    Returns
    -------
    dist_u : (n,) uniform ladder; mean_u, std_u : (..., n).
    """
    av_dist = np.asarray(av_dist, dtype=float)
    dist_u = np.linspace(av_dist[0], av_dist[-1], n)
    mean = np.atleast_2d(av_mean)
    std = np.atleast_2d(av_std)
    mean_u = np.stack([np.interp(dist_u, av_dist, m) for m in mean])
    std_u = np.stack([np.interp(dist_u, av_dist, s) for s in std])
    if np.ndim(av_mean) == 1:
        mean_u, std_u = mean_u[0], std_u[0]
    return dist_u, mean_u, std_u


def write_bayestar_file(path, pixel_nside, pixel_index, dists,
                        av_mean, av_std):
    """Write a Bayestar-schema dust map file (mirrors
    `dustmap.write_bayestar_file`): `pixel_info` (nside, healpix_index),
    `dists` float64, `av_mean` / `av_std` float32."""
    import h5py
    ptype = np.dtype([("nside", "<i8"), ("healpix_index", "<i8")])
    pinfo = np.empty(len(pixel_nside), dtype=ptype)
    pinfo["nside"] = pixel_nside
    pinfo["healpix_index"] = pixel_index
    with h5py.File(path, "w") as f:
        f.create_dataset("pixel_info", data=pinfo)
        f.create_dataset("dists", data=np.asarray(dists, dtype=np.float64))
        f.create_dataset("av_mean", data=np.asarray(av_mean,
                                                    dtype=np.float32))
        f.create_dataset("av_std", data=np.asarray(av_std, dtype=np.float32))


__all__ = ["DustMap", "Bayestar", "uniform_profile",
           "write_bayestar_file"]
