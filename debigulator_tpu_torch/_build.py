"""Build shared libraries from the repo's sources into the package's
git-ignored ``build/`` directory.

Each library's file name carries a hash of its sources and compile
command, so an edited source is rebuilt and a stale library is never
loaded.  A build writes to a private temporary name and renames it into
place, so concurrent first uses (test workers, the scan thread pool) never
load a half-written file.  Several libraries build in parallel: one
compiler process per library, all started together.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess

BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"


def _lib_path(name: str, sources: list[pathlib.Path], cmd: list[str]) -> pathlib.Path:
    h = hashlib.sha1()
    for src in sources:
        h.update(src.read_bytes())
    h.update("\0".join(cmd).encode())
    # The compiler's own version: a checkout moved to another machine
    # rebuilds instead of loading a library built elsewhere.
    h.update(subprocess.run([cmd[0], "--version"], capture_output=True,
                            timeout=60).stdout)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_libraries(specs: dict[str, tuple[list[pathlib.Path], list[str]]],
                    timeout: float = 600.0) -> dict[str, pathlib.Path]:
    """Build every missing library; return {name: path}.

    specs: {name: (sources, command)}; the command is the compiler argv
    without its output flag, sources included.  Raises RuntimeError with
    the compiler's output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths, procs = {}, {}
    for name, (sources, cmd) in specs.items():
        path = _lib_path(name, sources, cmd)
        paths[name] = path
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            cmd + ["-o", str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out = f"timed out after {timeout} s\n{out}"
        if proc.returncode != 0:
            failed.append(f"{name}: {' '.join(proc.args)}\n{out}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("library build failed:\n" + "\n".join(failed))
    return paths
