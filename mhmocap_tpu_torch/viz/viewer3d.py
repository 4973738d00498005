"""3D scene + humans visualization.

Port of `mhmocap_tpu/viz/viewer3d.py` (the reference's
BaseVisualizer / SceneHumansVisualizer / SkeletonVisualizer,
visualization.py:26-305,603-844):

  * scene point clouds from aggregated or per-frame RGB-D;
  * per-frame SMPL meshes with validity gating (invalid bodies are
    parked behind the camera);
  * 15-joint MuPoTs skeletons with per-joint visibility and an optional
    GT overlay through the evaluation's match list;
  * the Open3D key map (frame stepping, camera-true view, render-option
    reload, rotate / translate, capture), behind the same optional
    `open3d` import;
  * headless counterparts: `export()` writes PLY geometry and
    `capture_frame()` / `render_camera_view()` draw without a display.

The headless colour images are drawn into uint8 arrays without
matplotlib: the points are projected with the port's camera and
splatted one pixel each into the box a default matplotlib subplot with
an equal aspect would give them, at the JAX package's figure sizes
(600 x 600 captures, 960 x 960 camera view). The pixels are not
matplotlib's. Depth captures are the same z-buffer splat as the JAX
package's (`splat_depth`), uint16 millimetres. Images are written with
`io.write_png`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..io import write_png
from ..ops.cameras import project_points, unproject_points
from .export import blend_points, draw_lines

try:
    import open3d as o3d
    HAVE_OPEN3D = True
except Exception:  # pragma: no cover - environment dependent
    o3d = None
    HAVE_OPEN3D = False

# Distinct per-person colours (the JAX package's palette)
DEFAULT_VIS_COLORS = np.asarray([
    [0.93, 0.42, 0.36], [0.36, 0.93, 0.44], [0.38, 0.44, 0.93],
    [0.78, 0.36, 0.76], [0.91, 0.87, 0.18], [0.18, 0.91, 0.76],
    [0.14, 0.85, 0.99], [0.26, 0.52, 0.52], [0.86, 0.74, 0.74],
    [0.74, 0.95, 0.59], [0.71, 0.13, 0.13], [0.13, 0.47, 0.59],
    [0.38, 0.75, 0.95], [0.86, 0.42, 0.25], [0.50, 0.81, 0.25],
], np.float32)

RENDEROPTION_PATH = os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "renderoption.json")

# Open3D shows +y up / -z forward; camera-space geometry flips y and z
FLIP_YZ = np.array([[1, 0, 0, 0], [0, -1, 0, 0],
                    [0, 0, -1, 0], [0, 0, 0, 1]], np.float64)

# MuPoTs 17-joint skeleton links for full-layout exports
MUPOTS_LINKS = [
    (0, 16), (16, 1), (1, 15), (15, 14),
    (1, 2), (2, 3), (3, 4),
    (1, 5), (5, 6), (6, 7),
    (14, 8), (8, 9), (9, 10),
    (14, 11), (11, 12), (12, 13),
]

# Parent of each of the first 15 MuPoTs joints (-1 = none)
MUPOTS15_PARENT = [1, 2, 3, 4, -1, 1, 5, 6, 14, 8, 9, 14, 11, 12, 1]

# headless figures: side in pixels (the JAX package's figsize x dpi)
CAPTURE_PX = 600
CAMERA_VIEW_PX = 960
# matplotlib's default subplot box, as fractions of the figure
_SUBPLOT = {"left": 0.125, "right": 0.9, "bottom": 0.11, "top": 0.88}


def mupots15_pose_arrays(pose3d, vis, thr: float = 0.5):
    """(17+, 3) pose + (17+, 1) visibility -> 15-joint skeleton arrays
    (points (15, 3), links (15, 2) int, joint_ok (15,) bool). Spheres
    use `thr`, links the hard-coded 0.5 (the reference's quirk); hidden
    joints collapse to the origin, their links to (0, 0)."""
    pose3d = np.asarray(pose3d)[:15]
    vis = np.asarray(vis).reshape(-1)[:15]
    joint_ok = vis > thr
    points = np.where(joint_ok[:, None], pose3d, 0.0)
    links = []
    for i, parent in enumerate(MUPOTS15_PARENT):
        if vis[i] > 0.5 and parent >= 0 and vis[parent] > 0.5:
            links.append([i, parent])
        else:
            links.append([0, 0])
    return points, np.asarray(links, np.int32), joint_ok


def scene_pointcloud_arrays(scene_img, scene_depth, scene_mask, cam_K,
                            stride: int = 1):
    """Coloured scene point cloud (points (P, 3), colours (P, 3) in
    [0, 1]) from aggregated RGB-D, unprojected with the port's camera on
    the CPU."""
    H, W = np.asarray(scene_depth).shape
    ys, xs = np.mgrid[0:H:stride, 0:W:stride]
    uvd = np.stack([xs + 0.5, ys + 0.5, np.asarray(scene_depth)[ys, xs]],
                   axis=-1).reshape(-1, 3)
    pts = unproject_points(torch.as_tensor(uvd, dtype=torch.float32),
                           torch.as_tensor(np.asarray(cam_K, np.float32))
                           ).numpy()
    ok = np.asarray(scene_mask)[ys, xs].reshape(-1) > 0.5
    colors = np.asarray(scene_img)[ys, xs].reshape(-1, 3).astype(
        np.float32) / 255.0
    return pts[ok], colors[ok]


def write_ply_points(path, pts, colors=None):
    """ASCII PLY point cloud, the JAX package's text line for line."""
    pts = np.asarray(pts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if not len(pts):
            return
        if colors is None:
            np.savetxt(f, pts[:, :3], fmt="%.4f %.4f %.4f")
        else:
            c = (np.clip(np.asarray(colors), 0, 1) * 255).astype(int)
            np.savetxt(f, np.column_stack([pts[:, :3].astype(np.float64),
                                           c[:, :3]]),
                       fmt="%.4f %.4f %.4f %d %d %d")


def write_ply_mesh(path, verts, faces):
    """ASCII PLY triangle mesh, the JAX package's text line for line."""
    verts, faces = np.asarray(verts), np.asarray(faces)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(verts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n")
        np.savetxt(f, verts[:, :3], fmt="%.4f %.4f %.4f")
        np.savetxt(f, faces[:, :3], fmt="3 %d %d %d")


def splat_depth(points: np.ndarray, cam_K, image_size) -> np.ndarray:
    """Z-buffer point splat -> (H, W) float32 depth (0 = empty): each
    point's pixel is its projection truncated to an integer and then
    clipped to the image, in numpy's arithmetic of cam_K's dtype with
    float32 points; the nearest depth wins (scatter_reduce amin)."""
    W, H = image_size
    K = np.asarray(cam_K)
    dt = torch.from_numpy(np.zeros(0, np.result_type(K.dtype, np.float32))
                          ).dtype
    pts = torch.as_tensor(np.asarray(points, np.float32)).reshape(-1, 3)
    pts = pts[pts[:, 2] > 1e-3]
    depth = torch.full((H * W,), float("inf"), dtype=torch.float32)
    if len(pts):
        Kt = torch.as_tensor(K, dtype=dt)
        p = pts.to(dt)
        u = torch.clamp((Kt[0, 0] * p[:, 0] / p[:, 2] + Kt[0, 2]).to(
            torch.int64), 0, W - 1)
        v = torch.clamp((Kt[1, 1] * p[:, 1] / p[:, 2] + Kt[1, 2]).to(
            torch.int64), 0, H - 1)
        depth.scatter_reduce_(0, v * W + u, pts[:, 2], "amin")
    depth = depth.reshape(H, W).numpy()
    return np.where(np.isfinite(depth), depth, np.float32(0.0))


def project_to_pixels(points, K) -> np.ndarray:
    """(P, 3) camera points -> (P, 2) pixels with the port's camera, in
    float32 on the CPU."""
    return project_points(torch.as_tensor(np.asarray(points, np.float32)),
                          torch.as_tensor(np.asarray(K, np.float32))).numpy()


def splat_figure(size_px: int, image_size, layers) -> np.ndarray:
    """A white (size_px, size_px, 3) uint8 figure with a black frame
    around the data box: the box of matplotlib's default subplot shrunk
    to the (W, H) image's aspect and centred, data x in [0, W] and y in
    [0, H] down. `layers` is a list of (uv (P, 2) pixels, colours (P, 3)
    in [0, 1] or one colour, alpha): alpha 1 splats are opaque, others
    are composited per hit."""
    W, H = image_size
    fig = np.full((size_px, size_px, 3), 255, np.uint8)
    bx0, bx1 = _SUBPLOT["left"] * size_px, _SUBPLOT["right"] * size_px
    by0 = (1 - _SUBPLOT["top"]) * size_px
    by1 = (1 - _SUBPLOT["bottom"]) * size_px
    scale = min((bx1 - bx0) / W, (by1 - by0) / H)
    x0 = 0.5 * (bx0 + bx1) - 0.5 * scale * W
    y0 = 0.5 * (by0 + by1) - 0.5 * scale * H
    for uv, cols, alpha in layers:
        uv = np.asarray(uv, np.float64).reshape(-1, 2)
        xy = np.stack([x0 + scale * uv[:, 0], y0 + scale * uv[:, 1]], -1)
        inside = ((uv[:, 0] >= 0) & (uv[:, 0] <= W) & (uv[:, 1] >= 0)
                  & (uv[:, 1] <= H))
        rgb = np.rint(255 * np.clip(np.asarray(cols, np.float64), 0, 1))
        if alpha < 1:
            blend_points(fig, xy[inside], rgb.reshape(-1, 3)[0], alpha)
            continue
        rgb = np.broadcast_to(rgb, (len(xy), 3))[inside].astype(np.uint8)
        px = np.rint(xy[inside]).astype(np.int64)
        ok = ((px[:, 0] >= 0) & (px[:, 0] < size_px) & (px[:, 1] >= 0)
              & (px[:, 1] < size_px))
        fig[px[ok, 1], px[ok, 0]] = rgb[ok]
    corners = np.array([(x0, y0), (x0 + scale * W, y0),
                        (x0 + scale * W, y0 + scale * H),
                        (x0, y0 + scale * H)])
    draw_lines(fig, corners, np.roll(corners, -1, axis=0), (0, 0, 0))
    return fig


def _skeleton_points(frame):
    """12 samples along each drawn link of a frame's skeletons ->
    (points (P, 3), colours (P, 3))."""
    pts, cols = [], []
    for p, links, color in frame:
        for a, b in links:
            if a == b:
                continue
            pts.append(np.linspace(p[a], p[b], 12))
            cols.append(np.tile(color, (12, 1)))
    if not pts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    return np.concatenate(pts, 0), np.concatenate(cols, 0)


class BaseVisualizer:
    """Camera and render-option state shared by both visualizers."""

    def __init__(self, camera: Dict,
                 renderoption_filename: str = RENDEROPTION_PATH,
                 output_path: Optional[str] = None):
        self.cam = camera
        self.window_size = camera["image_size"]
        self.K = np.asarray(camera["K"])
        self.renderoption_filename = renderoption_filename
        self.output_path = os.path.realpath(output_path or "./")
        self.curr_frame = 0
        self.curr_image_index = 0

    # -- Open3D callbacks ------------------------------------------------
    def _camera_true_view(self, vis):
        """'U': set the viewpoint to the real camera."""
        ctr = vis.get_view_control()
        p = ctr.convert_to_pinhole_camera_parameters()
        win_w, win_h = p.intrinsic.width, p.intrinsic.height
        cam_w, cam_h = self.window_size
        p.intrinsic.set_intrinsics(
            win_w, win_h, win_w * self.K[0, 0] / cam_w,
            win_h * self.K[1, 1] / cam_h, win_w / 2 - 0.5,
            win_h / 2 - 0.5)
        p.extrinsic = FLIP_YZ
        ctr.convert_from_pinhole_camera_parameters(p)
        return False

    def _load_render_option(self, vis):
        """'R': reload the RenderOption JSON."""
        print("Loading render options from", self.renderoption_filename)
        vis.get_render_option().load_from_json(self.renderoption_filename)
        return False

    def _o3d_capture(self, vis, color: bool, depth: bool):
        """Save Open3D's buffers: img_%06d.png colour and
        depth_%06d.png uint16 millimetres."""
        if color:
            img = np.asarray(vis.capture_screen_float_buffer())
            write_png(os.path.join(self.output_path,
                                   f"img_{self.curr_image_index:06d}.png"),
                      (255 * img).astype(np.uint8))
        if depth:
            d = 1000.0 * np.asarray(vis.capture_depth_float_buffer())
            write_png(os.path.join(self.output_path,
                                   f"depth_{self.curr_image_index:06d}.png"),
                      d.astype(np.uint16))
        self.curr_image_index += 1
        return False

    # -- headless capture ------------------------------------------------
    def _headless_capture(self, points, colors, color: bool, depth: bool,
                          extra_points=None):
        """img_%06d.png (a splat figure) and depth_%06d.png (uint16
        millimetres), then the next image index."""
        os.makedirs(self.output_path, exist_ok=True)
        if color:
            uv = (project_to_pixels(points, self.K) if len(points)
                  else np.zeros((0, 2)))
            write_png(os.path.join(self.output_path,
                                   f"img_{self.curr_image_index:06d}.png"),
                      splat_figure(CAPTURE_PX, self.window_size,
                                   [(uv, colors, 1.0)]))
        if depth:
            allpts = points if extra_points is None else np.concatenate(
                [points, extra_points], axis=0)
            d = splat_depth(allpts, self.K, self.window_size)
            write_png(os.path.join(self.output_path,
                                   f"depth_{self.curr_image_index:06d}.png"),
                      (1000.0 * d).astype(np.uint16))
        self.curr_image_index += 1


def _floor_mesh(floor):  # pragma: no cover - needs open3d
    f = floor
    fv = o3d.utility.Vector3dVector(np.array(
        [[f["x1"], f["y1"], f["z1"]], [f["x1"], f["y2"], f["z2"]],
         [f["x2"], f["y2"], f["z2"]], [f["x2"], f["y1"], f["z1"]]]))
    ft = o3d.utility.Vector3iVector(np.array([[0, 3, 1], [1, 3, 2]]))
    mesh = o3d.geometry.TriangleMesh(fv, ft)
    mesh.paint_uniform_color(f["color"])
    mesh.transform(FLIP_YZ)
    return mesh


def _need_open3d():
    if not HAVE_OPEN3D:
        raise RuntimeError("Open3D is not installed; use export() for "
                           "headless artifacts")


class SceneHumansVisualizer(BaseVisualizer):
    """Scene point cloud(s) plus per-frame human meshes.

    Takes one aggregated scene (H, W, 3) / (H, W) or per-frame scenes
    (T, H, W, 3) / (T, H, W). Key map of `run()`: N steps frames (and
    captures when the capture flags are set), U camera-true view, R
    reload render options, J/L/I/K rotate, W/S/A/D/X translate, and C
    translate -z (the reference binds C to capture, then overwrites it).
    """

    def __init__(self, images, depths, camera,
                 vertices=None, faces=None, valid_vertices=None,
                 scene_mask=None, output_path=None,
                 capture_rendered_color: bool = False,
                 capture_rendered_depth: bool = False,
                 show_coordinate_axis: bool = True,
                 vis_color_list=DEFAULT_VIS_COLORS,
                 show_floor: bool = False,
                 floor_color=(0.2, 0.2, 0.2),
                 y1=-1, y2=-1, x1=-1, x2=1, z1=0, z2=4,
                 stride: int = 1, verbose: bool = True, **kw):
        super().__init__(camera, output_path=output_path,
                         **{k: v for k, v in kw.items()
                            if k == "renderoption_filename"})
        images = np.asarray(images)
        depths = np.asarray(depths)
        if images.ndim == 4 and depths.ndim == 3:
            self.multiple_scenes = True
            scenes = list(zip(images, depths))
        elif images.ndim == 3 and depths.ndim == 2:
            self.multiple_scenes = False
            scenes = [(images, depths)]
        else:
            raise ValueError(f"Invalid images/depths shape: {images.shape}, "
                             f"{depths.shape}")
        if scene_mask is None:
            scene_mask = np.ones(scenes[0][1].shape, np.float32)
        self.scene_frames = [
            scene_pointcloud_arrays(im, de, scene_mask, camera["K"], stride)
            for im, de in scenes]

        self.verts = None if vertices is None else np.asarray(vertices)
        self.faces = None if faces is None else np.asarray(faces)
        if valid_vertices is None and self.verts is not None:
            valid_vertices = np.ones(self.verts.shape[:2] + (1,), np.float32)
        self.valid = (None if valid_vertices is None
                      else np.asarray(valid_vertices))
        self.max_frames = (len(self.verts) if self.verts is not None
                           else len(self.scene_frames))
        self.capture_rendered_color = capture_rendered_color
        self.capture_rendered_depth = capture_rendered_depth
        self.show_coordinate_axis = show_coordinate_axis
        self.colors = np.asarray(vis_color_list)
        self.show_floor = show_floor
        self.floor = dict(color=floor_color, y1=y1, y2=y2, x1=x1, x2=x2,
                          z1=z1, z2=z2)
        self.verbose = verbose

    def _scene_of(self, t):
        return self.scene_frames[t % len(self.scene_frames)]

    def frame_vertices(self, t):
        """Per-person vertices at frame t; invalid bodies are parked
        behind the camera at (0, 0, -1)."""
        out = []
        for n in range(self.verts.shape[1]):
            v = self.verts[t, n]
            if self.valid is not None and self.valid[t, n, 0] <= 0.5:
                v = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32),
                            (len(v), 1))
            out.append(v)
        return out

    def capture_frame(self, t: Optional[int] = None):
        """Headless colour/depth capture of frame t (the current frame
        by default)."""
        t = self.curr_frame if t is None else t
        pts, cols = self._scene_of(t)
        if self.verts is not None:
            bodies = self.frame_vertices(t)
            body_cols = np.concatenate([
                np.tile(self.colors[n % len(self.colors)], (len(b), 1))
                for n, b in enumerate(bodies)], axis=0)
            pts = np.concatenate([pts] + bodies, axis=0)
            cols = np.concatenate([cols, body_cols], axis=0)
        self._headless_capture(pts, cols, self.capture_rendered_color,
                               self.capture_rendered_depth)

    def step(self, capture: bool = True):
        """Advance one frame (the 'N' key), capturing when the capture
        flags are set; `run()`'s callback passes capture=False and
        captures Open3D's buffers instead."""
        self.curr_frame = (self.curr_frame + 1) % self.max_frames
        if self.verbose:
            print(f"frame {self.curr_frame}")
        if (capture and (self.capture_rendered_color
                         or self.capture_rendered_depth)
                and not getattr(self, "_in_o3d_run", False)):
            self.capture_frame()
        return self.curr_frame

    def export(self, out_dir: str, max_frames: Optional[int] = 10):
        """scene.ply, human_%04d_%d.ply for the first `max_frames`
        frames (with their captures when the flags are set) and
        camera_view_0000.png, all in `out_dir`."""
        os.makedirs(out_dir, exist_ok=True)
        self.output_path = os.path.realpath(out_dir)
        pts, cols = self._scene_of(0)
        write_ply_points(os.path.join(out_dir, "scene.ply"), pts, cols)
        T = self.max_frames if max_frames is None else min(self.max_frames,
                                                           max_frames)
        for t in range(T):
            if self.verts is not None and self.faces is not None:
                for n, v in enumerate(self.frame_vertices(t)):
                    write_ply_mesh(
                        os.path.join(out_dir, f"human_{t:04d}_{n}.ply"), v,
                        self.faces)
            if self.capture_rendered_color or self.capture_rendered_depth:
                self.capture_frame(t)
        self.render_camera_view(os.path.join(out_dir, "camera_view_0000.png"),
                                frame=0)
        return out_dir

    def camera_view_layers(self, frame: int = 0):
        """The camera view's splat layers: the scene opaque, then each
        body's vertices in its colour at alpha 0.5."""
        pts, cols = self._scene_of(frame)
        layers = [(project_to_pixels(pts, self.K), cols, 1.0)]
        if self.verts is not None:
            for n, v in enumerate(self.frame_vertices(frame)):
                layers.append((project_to_pixels(v, self.K),
                               self.colors[n % len(self.colors)], 0.5))
        return layers

    def render_camera_view(self, path: str, frame: int = 0):
        """Camera-true splat render of a frame (headless)."""
        write_png(path, splat_figure(CAMERA_VIEW_PX, self.window_size,
                                     self.camera_view_layers(frame)))

    def run(self):  # pragma: no cover - needs a display + open3d
        _need_open3d()
        self._in_o3d_run = True
        pts, cols = self._scene_of(0)
        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(pts)
        pcd.colors = o3d.utility.Vector3dVector(cols)
        pcd.transform(FLIP_YZ)
        meshes = []
        if self.verts is not None and self.faces is not None:
            for n, v in enumerate(self.frame_vertices(0)):
                m = o3d.geometry.TriangleMesh()
                m.vertices = o3d.utility.Vector3dVector(v)
                m.triangles = o3d.utility.Vector3iVector(self.faces)
                m.compute_vertex_normals()
                m.paint_uniform_color(self.colors[n % len(self.colors)])
                m.transform(FLIP_YZ)
                meshes.append(m)

        vis = o3d.visualization.VisualizerWithKeyCallback()
        vis.create_window()
        vis.add_geometry(pcd)
        for m in meshes:
            vis.add_geometry(m)
        if self.show_coordinate_axis:
            axis = o3d.geometry.TriangleMesh.create_coordinate_frame()
            axis.transform(FLIP_YZ)
            vis.add_geometry(axis)
        if self.show_floor:
            vis.add_geometry(_floor_mesh(self.floor))

        def next_frame(v):
            t = self.step(capture=False)
            if self.multiple_scenes:
                p, c = self._scene_of(t)
                pcd.points = o3d.utility.Vector3dVector(p)
                pcd.colors = o3d.utility.Vector3dVector(c)
                pcd.transform(FLIP_YZ)
                v.update_geometry(pcd)
            for n, m in enumerate(meshes):
                m.vertices = o3d.utility.Vector3dVector(
                    self.frame_vertices(t)[n])
                m.compute_vertex_normals()
                m.transform(FLIP_YZ)
                v.update_geometry(m)
            if self.capture_rendered_color or self.capture_rendered_depth:
                self._o3d_capture(v, self.capture_rendered_color,
                                  self.capture_rendered_depth)
            return True

        def rotate(dx, dy):
            def cb(v):
                v.get_view_control().rotate(dx, dy)
                return False
            return cb

        def translate(fw, right, up):
            def cb(v):
                v.get_view_control().camera_local_translate(
                    forward=fw, right=right, up=up)
                return False
            return cb

        keys = {"N": next_frame, "U": self._camera_true_view,
                "R": self._load_render_option,
                "J": rotate(1, 0), "L": rotate(-1, 0), "I": rotate(0, 1),
                "K": rotate(0, -1), "W": translate(0.01, 0, 0),
                "S": translate(-0.01, 0, 0), "A": translate(0, 0.01, 0),
                "D": translate(0, -0.01, 0), "X": translate(0, 0, 0.01),
                # the reference's final binding of C
                "C": translate(0, 0, -0.01)}
        for key, cb in keys.items():
            vis.register_key_callback(ord(key), cb)
        try:
            vis.run()
        finally:
            vis.destroy_window()
            self._in_o3d_run = False


class SkeletonVisualizer(BaseVisualizer):
    """Per-frame 15-joint MuPoTs skeletons with an optional GT overlay:
    coloured prediction skeletons, grey GT skeletons paired through the
    evaluation's match list, an optional flat backdrop at `backdist`, a
    floor plane, the N/U/R keys and colour capture."""

    def __init__(self, camera, pred3d, pred_vis, pose_gt=None,
                 gt_vis=None, match_list=None, output_path=None,
                 capture_rendered_color: bool = False,
                 show_coordinate_axis: bool = False,
                 backimages=None, backdist: float = 6.0,
                 vis_color_list=DEFAULT_VIS_COLORS,
                 show_floor: bool = True,
                 floor_color=(0.2, 0.2, 0.2), radius: float = 0.03,
                 y1=-1, y2=-1, x1=-1, x2=1, z1=0, z2=4, **kw):
        super().__init__(camera, output_path=output_path,
                         **{k: v for k, v in kw.items()
                            if k == "renderoption_filename"})
        pred3d = np.asarray(pred3d)
        pred_vis = np.asarray(pred_vis)
        self.max_frames = len(pred3d)
        self.radius = radius
        self.colors = np.asarray(vis_color_list)
        self.capture_rendered_color = capture_rendered_color
        self.show_coordinate_axis = show_coordinate_axis
        self.show_floor = show_floor
        self.floor = dict(color=floor_color, y1=y1, y2=y2, x1=x1, x2=x2,
                          z1=z1, z2=z2)
        self.backimages = backimages
        self.backdist = backdist

        # per-frame skeletons: [(points, links, colour), ...]
        self.frames: List[List] = []
        for t in range(self.max_frames):
            skels = []
            if pose_gt is not None and gt_vis is not None:
                if match_list is None:
                    raise ValueError("the GT overlay needs the evaluation's "
                                     "match list")
                gt_idx, pred_idx = match_list[t]
                for n, (pi, gi) in enumerate(zip(pred_idx, gt_idx)):
                    p, l, _ = mupots15_pose_arrays(pred3d[t, pi],
                                                   pred_vis[t, pi], thr=0.5)
                    skels.append((p, l, self.colors[n % len(self.colors)]))
                    g, gl, _ = mupots15_pose_arrays(
                        np.asarray(pose_gt)[t, gi],
                        np.asarray(gt_vis)[t, gi], thr=0.1)
                    skels.append((g, gl, np.array([0.25, 0.25, 0.25])))
            else:
                for n in range(pred3d.shape[1]):
                    p, l, _ = mupots15_pose_arrays(pred3d[t, n],
                                                   pred_vis[t, n], thr=0.5)
                    skels.append((p, l, self.colors[n % len(self.colors)]))
            self.frames.append(skels)

    def capture_frame(self, t: Optional[int] = None):
        """Headless colour capture of frame t's skeletons."""
        t = self.curr_frame if t is None else t
        pts, cols = _skeleton_points(self.frames[t])
        self._headless_capture(pts, cols, True, False)

    def step(self, capture: bool = True):
        self.curr_frame = (self.curr_frame + 1) % self.max_frames
        if (capture and self.capture_rendered_color
                and not getattr(self, "_in_o3d_run", False)):
            self.capture_frame()
        return self.curr_frame

    def export(self, out_dir: str, max_frames: Optional[int] = 10):
        """skeleton_%04d.ply (and the colour captures when the flag is
        set) for the first `max_frames` frames, in `out_dir`."""
        os.makedirs(out_dir, exist_ok=True)
        self.output_path = os.path.realpath(out_dir)
        T = self.max_frames if max_frames is None else min(self.max_frames,
                                                           max_frames)
        for t in range(T):
            pts, cols = _skeleton_points(self.frames[t])
            if len(pts):
                write_ply_points(os.path.join(out_dir,
                                              f"skeleton_{t:04d}.ply"),
                                 pts, cols)
            if self.capture_rendered_color:
                self.capture_frame(t)
        return out_dir

    def run(self):  # pragma: no cover - needs a display + open3d
        _need_open3d()
        self._in_o3d_run = True
        spheres, lines = [], []
        for p, l, color in self.frames[0]:
            ls = o3d.geometry.LineSet()
            ls.points = o3d.utility.Vector3dVector(p)
            ls.lines = o3d.utility.Vector2iVector(l)
            ls.colors = o3d.utility.Vector3dVector(np.tile(color,
                                                           (len(l), 1)))
            ls.transform(FLIP_YZ)
            lines.append(ls)
            group = []
            for j in range(len(p)):
                s = o3d.geometry.TriangleMesh.create_sphere(
                    radius=self.radius, resolution=5)
                s.translate(p[j])
                s.paint_uniform_color(color)
                s.compute_vertex_normals()
                s.transform(FLIP_YZ)
                group.append(s)
            spheres.append(group)

        vis = o3d.visualization.VisualizerWithKeyCallback()
        vis.create_window()
        for group in spheres:
            for s in group:
                vis.add_geometry(s)
        for ls in lines:
            vis.add_geometry(ls)
        if self.backimages is not None:
            im = np.asarray(self.backimages)
            im0 = im[0] if im.ndim == 4 else im
            H, W = im0.shape[:2]
            pts, cols = scene_pointcloud_arrays(
                im0, self.backdist * np.ones((H, W), np.float32),
                np.ones((H, W), np.float32), self.cam["K"])
            pcd = o3d.geometry.PointCloud()
            pcd.points = o3d.utility.Vector3dVector(pts)
            pcd.colors = o3d.utility.Vector3dVector(cols)
            pcd.transform(FLIP_YZ)
            vis.add_geometry(pcd)
        if self.show_floor:
            vis.add_geometry(_floor_mesh(self.floor))

        def next_frame(v):
            t = self.step(capture=False)
            for (p, l, _), ls, group in zip(self.frames[t], lines, spheres):
                ls.points = o3d.utility.Vector3dVector(p)
                ls.lines = o3d.utility.Vector2iVector(l)
                ls.transform(FLIP_YZ)
                v.update_geometry(ls)
                for j, s in enumerate(group):
                    s.translate(p[j], relative=False)
                    v.update_geometry(s)
            if self.capture_rendered_color:
                self._o3d_capture(v, True, False)
            return True

        vis.register_key_callback(ord("N"), next_frame)
        vis.register_key_callback(ord("U"), self._camera_true_view)
        vis.register_key_callback(ord("R"), self._load_render_option)
        try:
            vis.run()
        finally:
            vis.destroy_window()
            self._in_o3d_run = False


def write_default_renderoption(path: str = RENDEROPTION_PATH):
    """(Re)write the shipped RenderOption JSON (an Open3D RenderOption
    dump, loaded with the 'R' key)."""
    opt = {
        "class_name": "RenderOption",
        "version_major": 1,
        "version_minor": 0,
        "background_color": [1.0, 1.0, 1.0],
        "default_mesh_color": [0.7, 0.7, 0.7],
        "mesh_color_option": 1,
        "mesh_shade_option": 0,
        "mesh_show_back_face": False,
        "mesh_show_wireframe": False,
        "light_on": True,
        "light_ambient_color": [0.0, 0.0, 0.0],
        "point_color_option": 0,
        "point_show_normal": False,
        "point_size": 2.0,
        "line_width": 4.0,
        "show_coordinate_frame": False,
        "image_max_depth": 3000,
        "image_stretch_option": 0,
        "interpolation_option": 0,
    }
    with open(path, "w") as f:
        json.dump(opt, f, indent=2, sort_keys=True)
    return path
