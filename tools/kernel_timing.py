"""Helpers shared by the tools/time_kernel_*.py scripts:
CUDA-event timing, the card's name and power limit, the ``ptxas`` report
and SASS opcode counts of the built library, and libraries built from
edited copies of one kernel source (ablation variants)."""

import ctypes
import re
from pathlib import Path
import shutil
import subprocess


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call on the card's timeline, after one
    warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sass_counts(path, opcodes, match):
    """Counts of ``opcodes`` per kernel of the library at ``path`` whose
    name contains ``match``. An opcode names a SASS mnemonic and any of
    its modifiers: "LDG.128" counts LDG.E.128 and LDG.E.EF.128 alike."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)],
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if match in fn:
                counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn in counts:
            m = re.search(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]+)",
                          line)
            if m:
                parts = m.group(1).split(".")
                for op in opcodes:
                    want = op.split(".")
                    if parts[0] == want[0] and set(want[1:]) <= set(parts[1:]):
                        counts[fn][op] += 1
    return counts


def ptxas_lines(log, match):
    """The ptxas lines (registers, spills, shared memory) of the kernels
    whose name contains ``match``, from an nvcc -Xptxas -v log."""
    lines = log.splitlines()
    return [" ".join(x.strip() for x in lines[i:i + 4])
            for i, line in enumerate(lines)
            if "Compiling entry" in line and match in line]


def ptxas_report(_build, match):
    """``ptxas_lines`` of the package's library, from its build log."""
    _build.load_library()
    return ptxas_lines(_build.build_info["log"], match)


def variant_spills(path, match):
    """Per kernel of a ``build_variants`` library whose name contains
    ``match``: its stack frame, spill and register counts."""
    report = ptxas_lines(Path(path).with_suffix(".log").read_text(), match)
    return [re.sub(r".*?(\d+ bytes stack frame.*)", r"\1", line)
            .replace("ptxas info    : ", "") for line in report]


class Variant:
    """Stands in for ``ops._build`` with another library."""

    def __init__(self, lib):
        self.lib = lib

    def load_library(self):
        return self.lib

    @staticmethod
    def check(lib, rc, name):
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")


def build_variants(_build, source, entry, ablations, unchanged=()):
    """Compile an edited copy of ``csrc/<source>`` per entry of
    ``ablations`` (name -> [(text, replacement)]), all at once, each into
    a library of its own (with the sources ``unchanged`` as they are)
    with the C entry point ``entry`` and its nvcc log beside it
    (``.log``). Returns name -> (ctypes library, path)."""
    src = (_build.CSRC / source).read_text()
    out = _build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    stem = source.rsplit(".", 1)[0]
    procs = {}
    for name, edits in ablations.items():
        text = src
        for old, new in edits:
            assert old in text, (name, old)
            text = text.replace(old, new)
        cu = out / f"{stem}_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(_build.CSRC), "-o", str(out / f"lib_{stem}_{name}.so"), str(cu),
             *(str(_build.CSRC / u) for u in unchanged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        path = out / f"lib_{stem}_{name}.so"
        path.with_suffix(".log").write_text(log)
        lib = ctypes.CDLL(str(path))
        getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
        getattr(lib, entry).restype = ctypes.c_int
        libs[name] = (lib, path)
    return libs
