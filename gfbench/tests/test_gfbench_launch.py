"""The launcher of a cell on several chips: every rank runs, rank 0's
standard output comes back to be printed after all have ended, and one
failing rank ends the others and gives its exit code."""
import textwrap
import time

from gfbench.harness import launch

SCRIPT = textwrap.dedent("""
    import argparse, sys, time
    p = argparse.ArgumentParser()
    p.add_argument("--fail", type=int, default=-1)
    p.add_argument("--rank", type=int)
    p.add_argument("--port", type=int)
    p.add_argument("--t0", type=float)
    a = p.parse_args()
    print(f"rank {a.rank} port {a.port}", flush=True)
    if a.rank == a.fail:
        sys.exit(7)
    if a.fail >= 0:
        time.sleep(60)
""")


def test_rank_zeros_output_comes_back(tmp_path):
    script = tmp_path / "ranks.py"
    script.write_text(SCRIPT)
    code, out = launch.spawn(str(script), [], 3, time.time())
    assert code == 0
    assert out.startswith("rank 0 port ") and "rank 1" not in out


def test_a_failing_rank_ends_the_others(tmp_path):
    script = tmp_path / "ranks.py"
    script.write_text(SCRIPT)
    t = time.time()
    code, out = launch.spawn(str(script), ["--fail", "2"], 3, t)
    assert code == 7 and out == ""
    assert time.time() - t < 30
