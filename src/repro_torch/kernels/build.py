"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (``extern "C"``
functions taking device pointers, sizes, scalars and a CUDA stream, and
returning the launch's ``cudaError_t``).  On first use it is compiled for
Hopper (``sm_90a``) into ``build/kernels/`` at the repository root, under
a file name that carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.  Nothing here runs at
import time: the CPU tests import every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Flags of one source only.  The SWE step must not contract a*b+c into FMAs:
# at 7 km depth one ulp of h is 0.5 mm of sea surface, whose pressure
# gradient moves the momentum by ~1e-4 of its size in a step, so the kernel
# keeps the plain version's IEEE rounding of every operation instead.  The
# Matérn kernels neither: the posterior mean keeps the bits of the matrix
# kernel followed by PyTorch's separately rounded multiplies and adds.
EXTRA_FLAGS = {"swe_flux": ("--fmad=false",), "matern": ("--fmad=false",)}

# A C signature: (restype, [argtypes]).
Signature = Tuple[object, Sequence[object]]


# Per thread: the tally of launches recorded while this thread captures a
# CUDA graph (see ``recording``), or None.
_CAPTURE = threading.local()


class LaunchCounter:
    """Thread-safe count of one kernel's launches on the card (balancer
    workers launch concurrently).

    A launch issued while its thread captures a CUDA graph is recorded, not
    run: it goes to that capture's tally and not to the count.  Each replay
    of the graph then adds the tally (``replayed=True``), so ``value`` stays
    the number of times the card ran the kernel, and ``replayed`` says how
    many of those came from graph replays."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._n = 0
        self._replayed = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1, *, replayed: bool = False) -> None:
        tally = getattr(_CAPTURE, "tally", None)
        if tally is not None:
            tally[self.name] = tally.get(self.name, 0) + n
            return
        with self._lock:
            self._n += n
            if replayed:
                self._replayed += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._replayed = 0

    @property
    def value(self) -> int:
        return self._n

    @property
    def replayed(self) -> int:
        return self._replayed


class KernelLibrary:
    """Builds (once) and loads (once) the shared libraries of a source
    directory (``csrc/`` unless told otherwise)."""

    def __init__(self, build_dir: Path = BUILD_DIR, csrc: Path = CSRC) -> None:
        self.build_dir = build_dir
        self.csrc = csrc
        self.ptxas_log: Dict[str, str] = {}
        self._libs: Dict[str, ctypes.CDLL] = {}
        self._lock = threading.Lock()

    @staticmethod
    def nvcc() -> str:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
        found = shutil.which("nvcc")
        if found is None:
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
        return found

    @staticmethod
    def flags(name: str) -> Tuple[str, ...]:
        return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())

    def target(self, name: str) -> Path:
        src = self.csrc / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(self.flags(name)).encode()
        ).hexdigest()[:16]
        return self.build_dir / f"{name}-{digest}.so"

    def build(self, names: Iterable[str]) -> None:
        """Compile every missing library, one ``nvcc`` per source, all
        started together; raise with the compiler's output on failure."""
        jobs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
        for name in names:
            so = self.target(name)
            if so.exists():
                continue
            self.build_dir.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [self.nvcc(), *self.flags(name), "-o", str(tmp), str(self.csrc / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((name, so, tmp, proc))
        errors = []
        for name, so, tmp, proc in jobs:
            out, _ = proc.communicate()
            self.ptxas_log[name] = out
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{out}")
                continue
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        if errors:
            raise RuntimeError("\n".join(errors))

    def sass_counts(self, name: str) -> Dict[str, int]:
        """SASS instructions (NOPs left out) of each kernel in the built
        library ``name``, by mangled function name, from ``cuobjdump -sass``."""
        tool = Path(self.nvcc()).with_name("cuobjdump")
        out = subprocess.run(
            [str(tool), "-sass", str(self.target(name))],
            capture_output=True, text=True, check=True,
        ).stdout
        counts: Dict[str, int] = {}
        fn = None
        for line in out.splitlines():
            head = re.match(r"\s*Function : (\S+)", line)
            if head:
                fn = head.group(1)
                counts[fn] = 0
            elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)\S", line):
                counts[fn] += 1
        return counts

    def load(self, name: str, signatures: Dict[str, Signature]) -> ctypes.CDLL:
        """The loaded library ``name``, built first if needed, with the C
        signatures of its functions declared."""
        with self._lock:
            lib = self._libs.get(name)
            if lib is None:
                self.build([name])
                lib = ctypes.CDLL(str(self.target(name)))
                for fn, (restype, argtypes) in signatures.items():
                    f = getattr(lib, fn)
                    f.restype = restype
                    f.argtypes = list(argtypes)
                self._libs[name] = lib
            return lib


LIBRARY = KernelLibrary()
COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    """The launch counter of kernel ``name`` (created on first request)."""
    c = COUNTERS.get(name)
    return c if c is not None else COUNTERS.setdefault(name, LaunchCounter(name))


def check_launch(err: int, kernel: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel '{kernel}' failed to launch (cudaError {err})")


def require_plain(tensors, kernel: str) -> None:
    """Raise unless every input of a kernel launch is a plain tensor.

    The kernels have no backward and no batching rule (nor had the Pallas
    kernels they replace a VJP), so a launch under autograd or a
    ``torch.func`` transform (``grad``, ``jacfwd``, ``vmap``) is refused
    here with the reason, never run through the plain version instead.  A
    tensor subclass (a DTensor, a FakeTensor) is refused too: a kernel
    reads the memory of the tensor it is given, which such a tensor does
    not own or does not have; a sharded caller hands the kernel its local
    shards (``local_map``)."""
    for t in tensors:
        if type(t) not in (torch.Tensor, torch.nn.Parameter):
            raise RuntimeError(
                f"{kernel}: the CUDA kernel takes plain tensors, got a "
                f"{type(t).__name__}; call it on local tensors (a DTensor's "
                "shards through local_map), never on a DTensor or a FakeTensor"
            )
        if t.requires_grad or torch._C._functorch.is_functorch_wrapped_tensor(t):
            raise RuntimeError(
                f"{kernel}: the CUDA kernel has no backward and no batching rule; "
                "call it on plain tensors, outside autograd and torch.func "
                "transforms (grad, jacfwd, vmap)"
            )


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


@contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Within the block, this thread's launches are tallied by counter name
    in the yielded dict instead of counted: the block captures a graph."""
    tally: Dict[str, int] = {}
    _CAPTURE.tally = tally
    try:
        yield tally
    finally:
        _CAPTURE.tally = None
