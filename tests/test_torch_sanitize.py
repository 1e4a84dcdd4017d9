"""The port's host runtime under ThreadSanitizer and AddressSanitizer +
UndefinedBehaviorSanitizer: `make tsan-torch` and `make asan-torch` build
qvz_tpu_torch/native/qvz_rt.cpp with its sanitizer harness into one
executable each, in a temporary directory, and run it. The harness calls
every runtime entry point from several threads where the package does,
checks each result, and decodes truncated and bit-flipped payloads from
buffers of their exact length."""

import os
import shutil
import subprocess

import pytest

ROOT = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))


def _links(cxx: str, sanitizer: str, tmp) -> bool:
    """Whether `cxx` links a trivial program with -fsanitize=sanitizer."""
    r = subprocess.run(
        [cxx, f"-fsanitize={sanitizer}", "-x", "c++", "-", "-o",
         str(tmp / "probe")],
        input="int main() { return 0; }\n", capture_output=True, text=True,
        timeout=120)
    return r.returncode == 0


@pytest.mark.parametrize("target,sanitizer", [
    ("tsan-torch", "thread"),
    ("asan-torch", "address,undefined"),
])
def test_runtime_under_sanitizer(target, sanitizer, tmp_path):
    cxx = os.environ.get("CXX", "g++")
    if shutil.which("make") is None or shutil.which(cxx) is None:
        pytest.skip(f"make or {cxx} is not installed")
    if not _links(cxx, sanitizer, tmp_path):
        pytest.skip(f"{cxx} cannot link with -fsanitize={sanitizer}")
    out = tmp_path / "build"
    r = subprocess.run(["make", "-s", "-C", ROOT, target,
                        f"TORCH_SAN_OUT={out}", f"CXX={cxx}"],
                       capture_output=True, text=True, timeout=240)
    log = r.stdout + r.stderr
    assert r.returncode == 0, log[-4000:]
    assert "sanitize harness: ALL OK" in r.stdout, log[-4000:]
    for report in ("WARNING: ThreadSanitizer", "ERROR: AddressSanitizer",
                   "runtime error:", "ERROR: LeakSanitizer"):
        assert report not in log, log[-4000:]
    for site in ("kmeans_iter", "well_jump", "tables ctx2/qsv",
                 "sharded fused", "primed shard", "precomputed encode",
                 "encode_lines", "replay_model", "corrupt payload"):
        assert site in r.stdout, r.stdout
