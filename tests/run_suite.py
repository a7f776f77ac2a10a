"""Run the test suite in a few short-lived pytest processes.

jax 0.9.0's XLA:CPU backend on this platform segfaults in
`backend_compile_and_load` (and, when the persistent cache is on, in
`deserialize_executable`) once a single process has accumulated ~150 tests'
worth of compiled executables — six consecutive full-suite runs died at the
same spot while every file passes in isolation (see tests/conftest.py and
CLAUDE.md gotcha 8). Chunking the suite across a handful of processes keeps
each one far below the cliff; this is the supported way to run everything:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tests/run_suite.py [extra pytest args...]

Exit code is non-zero if any chunk fails. Chunks are file-level and ordered,
so test IDs and coverage are identical to one big run.
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# balanced by observed runtime; each chunk stays well under the ~150-test
# per-process cliff. Ordered LONGEST-FIRST so the 2-worker pool packs well
# (measured post-trim: ~390/400/310/260 s on the 2-core dev box → ~11.5
# min wall at -j2).
CHUNKS = [
    ["test_parallel.py", "test_parcel.py", "test_perf_guards.py",
     "test_rainshaft.py", "test_sources.py", "test_spec.py",
     "test_special.py", "test_stepper.py", "test_utils.py"],
    ["test_pallas.py"],
    ["test_examples.py", "test_golden.py", "test_harness.py",
     "test_kernels.py", "test_native.py", "test_numerical.py"],
    ["test_box.py", "test_coalescence.py", "test_distributed.py",
     "test_distributions.py", "test_autodiff.py", "test_calibrate.py"],
]


def main() -> int:
    extra = sys.argv[1:]
    # COVERAGE=1: accumulate line coverage across the chunk processes and
    # emit coverage.xml at the end (CI uploads it to codecov, mirroring the
    # reference's codecov upload, /root/reference/.github/workflows/ci.yml:42)
    cov = os.environ.get("COVERAGE")
    cov_args = (
        ["--cov=cloudy_tpu", "--cov-append", "--cov-report="] if cov else []
    )
    listed = {f for chunk in CHUNKS for f in chunk}
    actual = {
        f for f in os.listdir(HERE)
        if f.startswith("test_") and f.endswith(".py")
    }
    missing = sorted(actual - listed)
    if missing:
        # new test files run in their own trailing chunk so nothing is
        # silently skipped
        CHUNKS.append(missing)
    # -jN / --jobs N: run chunks in N concurrent processes (they are
    # already process-isolated; on the 2-core dev box and the 4-core CI
    # runners 2 workers roughly halve the wall clock). Output is captured per chunk and
    # printed whole on completion so logs do not interleave.
    jobs = int(os.environ.get("SUITE_JOBS", "2"))
    for i, a in enumerate(list(extra)):
        if a == "--jobs" and i + 1 < len(extra):
            jobs = int(extra[i + 1])
            extra = extra[:i] + extra[i + 2:]
            break
        if a.startswith("-j") and a[2:].isdigit():
            jobs = int(a[2:])
            extra.remove(a)
            break
    if cov:
        jobs = 1  # coverage appends to one data file; keep it serial

    def run_chunk(chunk):
        paths = [os.path.join(HERE, f) for f in chunk]
        p = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", *cov_args, *extra, *paths],
            capture_output=True, text=True,
        )
        r = 0 if p.returncode == 5 else p.returncode
        # 5 = no tests collected (e.g. -m slow on a slow-free chunk)
        return chunk, r, p.stdout + p.stderr

    rc = 0
    if jobs <= 1:
        results = [run_chunk(c) for c in CHUNKS]
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=jobs) as ex:
            results = list(ex.map(run_chunk, CHUNKS))
    for chunk, r, out in results:
        print(out, flush=True)
        print(f"[run_suite] chunk {chunk[0]}.. -> exit {r}", flush=True)
        rc = rc or r
    if cov:
        subprocess.call([sys.executable, "-m", "coverage", "xml"])
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
