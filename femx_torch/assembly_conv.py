"""Conv-form structured apply (port of femx/assembly_conv.py): K @ u as ONE
3x3x3, 24-channel correlation.

The slot-form apply (`StructuredSolidOperator.apply`) gathers the (81, C)
slot stack of every cell and overlap-adds the 27 slot results back. The same
operator, viewed on the CELL lattice, is a constant-coefficient 27-point
BLOCK stencil: space-to-depth the 8 parity phases into 24 channels (8 phases
x 3 components) on the (nx+1, ny+1, nz+1) cell grid, and K @ u becomes a
single 3x3x3 cross-correlation with a constant (24, 24, 3, 3, 3) kernel
derived from the 81x81 cell matrix: one read of u, one write of out.

Boundary closure: the free-space correlation sums over ALL integer cells;
cells outside [0, n-1] per axis ("phantom" layers q = -1 and q = n)
overcount exactly those terms whose reads AND writes both land on real
boundary nodes. Phantom layer q = -1 survives only with slot offsets
(so, si) = (2, 2) on that axis (the low node plane), q = n only with (0, 0)
(the high node plane): single-tap, phase-bit-0 channels. The union over the
6 phantom slabs is corrected by inclusion-exclusion over the 26 nonempty
face/edge/corner constraint combinations, each a plane/line/point-restricted
correlation whose kernel is enumerated by the same (so, si) -> (channel,
tap) mapping.

femx computes the correlations with lax.conv_general_dilated at
Precision.HIGHEST, an XLA op and not a Pallas kernel; here they are
torch.nn.functional.conv3d/conv2d/conv1d with padding 1 (cuDNN on the
card, with TF32 off, femx_torch.config) and a matvec for the 8 corners.
femx builds the 27 kernels inside jit and XLA hoists the build out of the
solve loop; eager torch would rebuild them on every apply, so `conv_kernels`
builds them once per operator, dtype and device (summed in float64, the
sign of each boundary correction folded in) and keeps them on the operator.
The correction slabs are basic-slice views of a (2, 2, 2, 3, X, Y, Z) view
of the channel grid, updated in place.

Only the unweighted operator has a constant stencil; the caller's routing
(assembly_structured.conv_routing_active) keeps the layer-weighted coarse
levels in slot form.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["apply_conv", "build_kernels", "conv_kernels"]

# Slot offsets in half-lattice units, matching the structured operator's
# _SLOTS: slot index s = 9a + 3b + c, Kcell row/col index = 3*s + component.
_OFFSETS = [(a, b, c) for a in range(3) for b in range(3) for c in range(3)]

# Per-axis constraint modes: F = free (interior conv axis, 3 taps),
# L = phantom cell layer q = -1 (low node plane, slot offsets (2, 2)),
# H = phantom cell layer q = n (high node plane, slot offsets (0, 0)).
_AXIS_MODES = ("F", "L", "H")

Mode = Tuple[str, str, str]


def _conforms(mode: str, a: int, ap: int) -> bool:
    if mode == "F":
        return True
    if mode == "L":
        return a == 2 and ap == 2
    return a == 0 and ap == 0  # "H"


def _restricted_channels(mode3: Mode) -> List[int]:
    """Channels (3*phase + comp) whose phase bit is 0 on constrained axes."""
    chans = []
    for px in (0, 1):
        for py in (0, 1):
            for pz in (0, 1):
                bits = (px, py, pz)
                if any(m != "F" and b != 0 for m, b in zip(mode3, bits)):
                    continue
                pidx = 4 * px + 2 * py + pz
                chans.extend(3 * pidx + c for c in range(3))
    return chans


@lru_cache(maxsize=None)
def _kernel_tables():
    """Constant tables mapping Kcell.flat entries into each mode's kernel.

    Returns {mode3: (cho, chi, kshape, src_flat, dst_flat, nseg)} where
    kernel_S.flat[dst] = segment_sum(Kcell.flat[src], dst) and kshape is
    (len(cho), len(chi), *3-per-free-axis).
    """
    tables = {}
    for mx in _AXIS_MODES:
        for my in _AXIS_MODES:
            for mz in _AXIS_MODES:
                mode3 = (mx, my, mz)
                cho = _restricted_channels(mode3)
                chi = cho  # same restriction on both sides
                cho_pos = {c: i for i, c in enumerate(cho)}
                free = [ax for ax, m in enumerate(mode3) if m == "F"]
                kshape = (len(cho), len(chi)) + (3,) * len(free)
                src, dst = [], []
                for so_i, so in enumerate(_OFFSETS):
                    for si_i, si in enumerate(_OFFSETS):
                        if not all(_conforms(m, so[ax], si[ax])
                                   for ax, m in enumerate(mode3)):
                            continue
                        po = 4 * (so[0] % 2) + 2 * (so[1] % 2) + (so[2] % 2)
                        pi = 4 * (si[0] % 2) + 2 * (si[1] % 2) + (si[2] % 2)
                        taps = tuple(si[ax] // 2 - so[ax] // 2 + 1 for ax in free)
                        for co in range(3):
                            o = cho_pos.get(3 * po + co)
                            if o is None:
                                continue
                            for ci in range(3):
                                i = cho_pos.get(3 * pi + ci)
                                if i is None:
                                    continue
                                d = (o, i) + taps
                                dst.append(int(np.ravel_multi_index(d, kshape)))
                                src.append((3 * so_i + co) * 81 + 3 * si_i + ci)
                tables[mode3] = (
                    tuple(cho), tuple(chi), kshape,
                    np.asarray(src, dtype=np.int64),
                    np.asarray(dst, dtype=np.int64),
                    int(np.prod(kshape)),
                )
    return tables


def build_kernels(Kcell: torch.Tensor) -> Dict[Mode, torch.Tensor]:
    """All 27 conv kernels from the (81, 81) cell matrix, float64, on
    Kcell's device: femx's gather + segment-sum as one index_add_ each."""
    flat = Kcell.reshape(-1).to(torch.float64)
    dev = flat.device
    out = {}
    for mode3, (_cho, _chi, kshape, src, dst, nseg) in _kernel_tables().items():
        k = torch.zeros(nseg, dtype=torch.float64, device=dev)
        k.index_add_(0, torch.as_tensor(dst, device=dev), flat[torch.as_tensor(src, device=dev)])
        out[mode3] = k.reshape(kshape)
    return out


def conv_kernels(op, dtype: torch.dtype, device: torch.device):
    """(full kernel, [(mode3, signed correction kernel), ...]) of `op` in
    `dtype` on `device`, built once per operator, dtype and device and kept
    on the operator. The corrections keep femx's order, each multiplied by
    its inclusion-exclusion sign (-1)^|S| before the one cast."""
    cache = op.__dict__.setdefault("_conv_kernels", {})
    key = (dtype, torch.device(device))
    if key not in cache:
        ks = build_kernels(op.Kcell.to(device))
        corrections = []
        for mode3, W in ks.items():
            ncon = sum(m != "F" for m in mode3)
            if ncon:
                corrections.append((mode3, ((-1.0) ** ncon * W).to(dtype)))
        cache[key] = (ks[("F", "F", "F")].to(dtype), corrections)
    return cache[key]


def _correlate(sub: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Cross-correlate (Ci, *spatial) with (Co, Ci, *3s), SAME padding."""
    nfree = sub.dim() - 1
    if nfree == 0:
        return W @ sub
    conv = (F.conv1d, F.conv2d, F.conv3d)[nfree - 1]
    return conv(sub[None], W, padding=1)[0]


def apply_conv(op, u: torch.Tensor) -> torch.Tensor:
    """K @ u (internal phase-major layout) through the conv-form stencil.

    Valid only for the unweighted operator (x/y/z_weight all None): the
    per-layer weights make the stencil position-dependent, which a
    convolution cannot express. The caller's routing enforces it."""
    nx, ny, nz = op.n_cells
    ext = (nx + 1, ny + 1, nz + 1)
    phases = op._split_phases(u)
    # Space-to-depth: 24 channels on the uniform (nx+1, ny+1, nz+1) cell
    # grid; phase-1 tails stay ZERO (the boundary closure relies on reading
    # exact zeros there).
    U = u.new_zeros((8, 3) + ext)
    for p, ph in enumerate(phases):
        U[p, :, :ph.shape[1], :ph.shape[2], :ph.shape[3]] = ph
    full, corrections = conv_kernels(op, u.dtype, u.device)
    out = _correlate(U.view((24,) + ext), full)
    # Inclusion-exclusion boundary closure: out_true = full
    # + sum_{S nonempty} (-1)^{|S|} E(S) over the 26 face/edge/corner
    # constraint combinations (the signs are in the kernels). Channel c =
    # 3 * (4 px + 2 py + pz) + comp, so fixing a phase bit to 0 is a slice.
    U7 = U.view((2, 2, 2, 3) + ext)
    out7 = out.view((2, 2, 2, 3) + ext)
    for mode3, W in corrections:
        idx = (tuple(slice(None) if m == "F" else 0 for m in mode3) + (slice(None),)
               + tuple(slice(None) if m == "F" else (0 if m == "L" else ext[ax] - 1)
                       for ax, m in enumerate(mode3)))
        sub = U7[idx]
        nfree = sum(m == "F" for m in mode3)
        free_shape = sub.shape[sub.dim() - nfree:]
        corr = _correlate(sub.reshape((W.shape[0],) + free_shape), W)
        out7[idx].add_(corr.view(sub.shape))
    res = torch.empty_like(u)
    out8 = out.view((8, 3) + ext)
    for p, ph in enumerate(op._split_phases(res)):
        ph.copy_(out8[p, :, :ph.shape[1], :ph.shape[2], :ph.shape[3]])
    return res
