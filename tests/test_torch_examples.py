"""The port's five filter examples (``examples/torch_*.py``) run with
``--device cpu`` at a small size, each in a process of its own: rc 0
(each example asserts its own facts) and the facts its reference example
prints, read back from its output: zero false negatives and blocked
blind deletes (quickstart), repaired false positives with the denylist
intact (adaptive), every routed and deferred key resident
(distributed), prefix hits (serving), dropped duplicates and a retired
window (streaming)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]

CASES = {
    "quickstart": ["--keys", "12000"],
    "adaptive_abuse_detection": ["--flagged", "2000", "--traffic", "12000",
                                 "--n-buckets", "1024"],
    "distributed_membership": ["--keys", "8192", "--n-buckets", "1024"],
    "serve_with_prefix_cache": ["--requests", "6", "--prefix-len", "32",
                                "--gen", "4"],
    "streaming_dedup": ["--base", "500", "--burst", "2000", "--capacity",
                        "4096"],
}


def run_example(name: str, args: list) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"),
         "--device", "cpu", *args], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


def _int(pattern: str, text: str) -> int:
    m = re.search(pattern, text)
    assert m, pattern
    return int(m.group(1))


def check(name: str, out: str) -> None:
    if name == "quickstart":
        assert _int(r"false negatives: (\d+)", out) == 0
        assert _int(r"blind deletes blocked: (\d+)", out) == 1000
        assert _int(r"grow=(\d+)", out) > 0
        assert _int(r"shrinks=(\d+)", out) > 0
        assert "capacity history: [4096," in out
    elif name == "adaptive_abuse_detection":
        assert _int(r"round 0: false positives=\s*(\d+)", out) > 0
        assert _int(r"replayed population: (\d+)", out) == 0
        assert "zero false negatives" in out
    elif name == "distributed_membership":
        assert _int(r"present keys found: (\d+)/8192", out) == 8192
        assert _int(r"survivors found: (\d+)/4096", out) == 4096
        assert _int(r"(\d+) deferred", out) > 0
        assert "pending=0" in out
        assert "every burst key resident" in out
    elif name == "serve_with_prefix_cache":
        assert _int(r"\((\d+) blocks reused\)", out) > 0
        assert "prefix-cache hit rate:" in out and "OcfStats(" in out
    elif name == "streaming_dedup":
        assert _int(r"(\d+) duplicates dropped", out) > 0
        assert _int(r"spills=(\d+)", out) >= 0
        assert re.search(r"after TTL: \d+ generations retired", out)


@pytest.mark.parametrize("name", list(CASES))
def test_example_runs_on_the_cpu(name):
    check(name, run_example(name, CASES[name]))


def test_distributed_example_runs_a_part_a_shard():
    """``--cards`` lays the shards out one part a shard (on the CPU here,
    every part there); the example's facts hold as in one part."""
    out = run_example("distributed_membership",
                      [*CASES["distributed_membership"], "--cards", "4"])
    check("distributed_membership", out)
    assert "shards on ['cpu', 'cpu'," in out


def test_examples_default_to_the_card():
    """Without ``--device`` an example asks for the card, and raises
    without one rather than run on the CPU."""
    for name in CASES:
        src = (ROOT / "examples" / f"torch_{name}.py").read_text()
        assert 'ap.add_argument("--device", default="cuda")' in src, name
        assert "import jax" not in src and "from repro." not in src, name
