"""Wrapper of the hand-written vertex-normals kernel, ``csrc/normals.cu``.

The plain PyTorch version is
:func:`softbodyunity_torch.solver.normals.vertex_normals`.
:func:`softbodyunity_torch.api.normals` takes this wrapper for every scene on
a CUDA device and the plain version for every other one: the device alone
decides.  The kernel takes float32 and float64 positions; it has no
backward, so positions that require grad raise.

Each scene's tables and the C argument block are packed once, into a
:class:`NormalsScene`, which :func:`softbodyunity_torch.api.normals` keeps
per scene.  A call is one ``ctypes`` call, one launch on the current
stream, counted once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.topology import Topology
from ..solver.normals import incident_faces
from ..utils import profiling
from .build import Library

# the device type the kernel runs on
DEVICE_TYPE = "cuda"


# launch_count(): kernel launches since the last reset_launch_count(), one a
# call of a scene with vertices
launch_count, reset_launch_count = profiling.launch_views("normals")


def face_table(triangles: torch.Tensor, n_vertices: int) -> torch.Tensor:
    """int32 ``[D, N]``: column v is row v of :func:`incident_faces`, the
    pads (``F``) included, so that slot k of neighbouring vertices lies
    side by side."""
    return incident_faces(triangles, n_vertices).t().to(
        torch.int32).contiguous()


class _Scene(ctypes.Structure):
    """``csrc/normals.cu::NormalsScene`` field by field."""

    _fields_ = [("tris", ctypes.c_void_p), ("table", ctypes.c_void_p),
                ("n", ctypes.c_int), ("n_face", ctypes.c_int),
                ("depth", ctypes.c_int), ("device", ctypes.c_int)]


@functools.cache
def _library():
    """``({dtype: its C entry}, the library)``."""
    lib = Library("normals", scene=_Scene)
    return {dtype: lib.declare(f"vertex_normals_{suffix}", [
        ctypes.POINTER(_Scene), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]) for dtype, suffix in (
            (torch.float32, "f32"), (torch.float64, "f64"))}, lib


class NormalsScene:
    """One scene's triangles (int32 ``[F, 3]``) and incident-face table
    (:func:`face_table`) on its device, with the C struct that points at
    them; calling it with positions ``x`` ``[N, 3]`` returns their unit
    vertex normals in a new tensor."""

    def __init__(self, top: Topology):
        if top.device.type != DEVICE_TYPE:
            raise ValueError(f"the normals kernel runs on a {DEVICE_TYPE} "
                             f"device, not on {top.device}")
        tri, n = top.triangles, top.n_vertices
        n_face = int(tri.shape[0])
        if max(n, 3 * n_face) >= 2 ** 31:
            raise ValueError("the normals kernel indexes vertices and faces "
                             "with int32")
        if n_face and (int(tri.min()) < 0 or int(tri.max()) >= n):
            raise ValueError(f"a triangle names a vertex outside 0..{n - 1}")
        # a CUDA tensor's device always has an index
        self.device, self.index, self.n = top.device, top.device.index or 0, n
        self.tris = tri.to(torch.int32).contiguous()
        self.table = face_table(tri, n)
        self.args = _Scene(self.tris.data_ptr(), self.table.data_ptr(), n,
                           n_face, int(self.table.shape[0]), self.index)
        self._ref = ctypes.byref(self.args)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        sp = profiling.begin("normals.call") if profiling.on else -1
        if x.device != self.device or tuple(x.shape) != (self.n, 3):
            raise ValueError(
                f"x is {tuple(x.shape)} on {x.device}; the scene's normals "
                f"take ({self.n}, 3) on {self.device}")
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"x is {x.dtype}; the kernel takes float32 and "
                            "float64")
        if x.requires_grad:
            raise NotImplementedError(
                "x requires grad; the backward kernel is not ported yet "
                "(ROADMAP Queue 1 item 9)")
        x = x.contiguous()
        out = torch.empty_like(x)
        if self.n:
            calls, lib = _library()
            # the C call makes the scene's device current for the launch
            stream = torch.cuda.current_stream(self.index).cuda_stream
            err = calls[x.dtype](self._ref, x.data_ptr(), out.data_ptr(),
                                 stream)
            profiling.add("normals")
            lib.check_launch(err, "vertex_normals")
        if sp >= 0:
            profiling.end(sp)
        return out
