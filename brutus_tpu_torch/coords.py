"""
Closed-form Galactic -> Galactocentric coordinate transform (the port's
copy of `brutus_tpu/coords.py`).

The astropy chain of the reference (`brutus/pdf.py:630-635`)

    galactic (l, b, d) -> galactic cartesian -> ICRS cartesian
                       -> galactocentric cartesian -> cylindrical (R, Z)

collapses into one affine map `x_gc = M @ x_gal + t`; `M` (`_M`) and
`t` (`_T`) are built in float64 numpy from the frame constants astropy
v4+ uses (J2000 NGP and node; Sgr A* at ICRS (266.4051, -28.936175) deg,
R_sun = 8.122 kpc, z_sun = 20.8 pc, roll0 = 58.5986320306 deg).
"""

import numpy as np
import torch

# --- frame constants (degrees / kpc) ---
NGP_RA = 192.8594812065348
NGP_DEC = 27.12825118085622
LON0 = 122.9319185680026

GALCEN_RA = 266.4051
GALCEN_DEC = -28.936175
GALCEN_DISTANCE = 8.122          # kpc
Z_SUN = 20.8e-3                  # kpc
ROLL0 = 58.5986320306


def _rot(angle_deg, axis):
    """Passive rotation matrix about `axis` by `angle_deg` (astropy
    `rotation_matrix` convention: rotates the coordinate frame)."""
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
    if axis == "y":
        return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    if axis == "z":
        return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    raise ValueError(axis)


def _build_affine():
    # ICRS -> Galactic (J2000 pole + node).
    R_icrs_to_gal = (_rot(180.0 - LON0, "z")
                     @ _rot(90.0 - NGP_DEC, "y")
                     @ _rot(NGP_RA, "z"))
    R_gal_to_icrs = R_icrs_to_gal.T

    # ICRS -> Galactocentric: align x with the GC direction, roll into
    # the galactic plane, then tilt for the Sun's height and translate.
    R = (_rot(ROLL0, "x")
         @ _rot(-GALCEN_DEC, "y")
         @ _rot(GALCEN_RA, "z"))
    tilt = -np.arcsin(Z_SUN / GALCEN_DISTANCE)
    H = _rot(np.rad2deg(tilt), "y")
    offset = -H @ np.array([GALCEN_DISTANCE, 0.0, 0.0])

    M = H @ R @ R_gal_to_icrs
    return M, offset


_M, _T = _build_affine()


def galactic_to_galactocentric(l_deg, b_deg, dist_kpc):
    """Galactic `(l, b, d)` -> galactocentric cartesian `(x, y, z)`.

    `l_deg`, `b_deg`, `dist_kpc` broadcast; distances in kpc.
    """
    dist_kpc = torch.as_tensor(dist_kpc)
    dt = dist_kpc.dtype
    l = torch.deg2rad(torch.as_tensor(l_deg, dtype=dt,
                                      device=dist_kpc.device))
    b = torch.deg2rad(torch.as_tensor(b_deg, dtype=dt,
                                      device=dist_kpc.device))
    cb = torch.cos(b)
    x = dist_kpc * cb * torch.cos(l)
    y = dist_kpc * cb * torch.sin(l)
    z = dist_kpc * torch.sin(b)
    M = torch.as_tensor(_M, dtype=dt, device=dist_kpc.device)
    t = torch.as_tensor(_T, dtype=dt, device=dist_kpc.device)
    xyz = torch.stack([x, y, z], dim=-1)
    out = xyz @ M.T + t
    return out[..., 0], out[..., 1], out[..., 2]


def galactic_to_cylindrical(l_deg, b_deg, dist_kpc):
    """Galactocentric cylindrical `(R, Z)` (reference
    `brutus/pdf.py:634-635`)."""
    x, y, z = galactic_to_galactocentric(l_deg, b_deg, dist_kpc)
    return torch.hypot(x, y), z


__all__ = ["galactic_to_galactocentric", "galactic_to_cylindrical",
           "GALCEN_DISTANCE", "Z_SUN"]
