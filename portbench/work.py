"""The yardstick's arithmetic: peaks, operations and bytes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W): 67 TFLOP/s
in float32 outside the tensor cores, 3.35 TB/s of HBM. The port runs in
float32 with TF32 off, so 67 TFLOP/s is its peak.

Raster kernels: a frozen copy of the itemisation of `chip_smoke.py`
(phase 3), counted on pairs the reference enumerates, so that the count
does not depend on how a kernel schedules its work. A transcendental
counts as one operation, |x| or -x as a free operand modifier:
  forward, per live pair: 3 edge planes (9), the bbox clamp's x part and
    its max with the y part (4), max (3), d|d| inv_blur (2), log-sigmoid
    (4), sum (1), cover test (1); per covered pair: z plane (3),
    z > znear, z-min and winner (4); per live row: the 4 planes' y
    products (4), the bbox's y part (3);
  backward, per live pair: 3 edge planes (9), bbox (4), max (3), |d|,
    d|d|, inv_blur (3), sigmoid (4), g (4), routing to the winning edge
    (3), its 3 sums (3); per depth winner: its 3 sums (3); per live
    row: the 3 edge planes' y products (3), the bbox's y part (3), the
    12 sums' rebase (24).
Bytes: each input read once and each output written once: a face's 12
plane coefficients and 4 bbox values, and per window pixel the depth,
the log-coverage and the winner (forward outputs, backward inputs with
the two cotangents in their place), and the backward's 12 plane
gradients a face.
"""

from __future__ import annotations

F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

RASTER_OPS = {"fwd": {"live": 24, "covered": 7, "rows": 7},
              "bwd": {"live": 33, "winners": 3, "rows": 30}}


def raster_ops(kind: str, work) -> int:
    return sum(n * getattr(work, k) for k, n in RASTER_OPS[kind].items())


def raster_bytes(kind: str, bodies: int, faces: int, win: int) -> int:
    face_in = bodies * faces * 16 * 4
    pixels = bodies * win * win * 4
    if kind == "fwd":
        return face_in + 3 * pixels
    return face_in + 3 * pixels + bodies * faces * 12 * 4


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the float32
    peak or bytes over the bandwidth, whichever is longer."""
    return max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def skin_flops(num_vertices: int) -> int:
    """Float32 operations of one body's skinning as the loss needs it:
    shape blend (10 betas), rest joints (24 regressor rows), pose blend
    (207 features), the blend of 24 transforms, the per-vertex 3x4
    transform and the 17 keypoint rows."""
    V = num_vertices
    return V * (2 * 10 * 3 + 2 * 24 * 3 + 2 * 207 * 3 + 2 * 24 * 12 + 18
                + 2 * 17 * 3)


def cycle_flops(lay, raster_calls, num_vertices: int):
    """Itemised float32 operations of an average stage-1 cycle of layout
    `lay` whose raster calls did `raster_calls` [(window, bodies,
    Work)]. Terms: skinning forward and backward (the backward takes
    the activations' gradients only, about the forward's count), the
    One-Euro refresh's skinning once every `filter_every` cycles, both
    raster kernels, the contact queries (squared distances to every
    scene pixel), the window losses (about 50 a window pixel, forward
    and backward) and the occlusion masks. Left out, each under 1% of
    a cycle: the scene rebuild (temporal median, bilateral, Sobel,
    fill-in), the One-Euro recursion, the 2D and regularizer terms, the
    optimizer."""
    bodies = lay.num_chunks * (lay.chunk + 1) * lay.N
    skin = skin_flops(num_vertices)
    side2 = lay.side * lay.side
    items = {
        "skin_fwd": bodies * skin,
        "skin_bwd": bodies * skin,
        "skin_refresh": lay.padded * lay.N * skin / lay.filter_every,
        "raster_fwd": sum(raster_ops("fwd", w) for _, _, w in raster_calls),
        "raster_bwd": sum(raster_ops("bwd", w) for _, _, w in raster_calls),
        "contact": lay.padded * lay.N * side2 * 8,
        "window_losses": 50 * sum(b * win * win
                                  for win, b, _ in raster_calls),
        "occlusion": lay.padded * 2 * lay.N * lay.N * side2,
    }
    return items
