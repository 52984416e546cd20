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
from .build import check_launch

# the device type the kernel runs on
DEVICE_TYPE = "cuda"


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`: one a
    call of a scene with vertices."""
    return profiling.count("normals")


def reset_launch_count() -> None:
    profiling.reset_count("normals")


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
def _launchers():
    """``({dtype: its C entry}, the error-string function)``."""
    from .build import load_library

    lib = load_library("normals")
    size = lib.normals_scene_size
    size.restype = ctypes.c_int
    if size() != ctypes.sizeof(_Scene):
        raise RuntimeError(
            f"normals: the C scene struct has {size()} bytes, its ctypes "
            f"mirror {ctypes.sizeof(_Scene)}")
    calls = {torch.float32: lib.vertex_normals_f32,
             torch.float64: lib.vertex_normals_f64}
    for call in calls.values():
        call.argtypes = [ctypes.POINTER(_Scene), ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p]
        call.restype = ctypes.c_int
    lib.normals_error_string.argtypes = [ctypes.c_int]
    lib.normals_error_string.restype = ctypes.c_char_p
    return calls, lib.normals_error_string


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
            calls, error_string = _launchers()
            # the C call makes the scene's device current for the launch
            stream = torch.cuda.current_stream(self.index).cuda_stream
            err = calls[x.dtype](self._ref, x.data_ptr(), out.data_ptr(),
                                 stream)
            profiling.add("normals")
            check_launch(err, "vertex_normals", error_string)
        if sp >= 0:
            profiling.end(sp)
        return out
