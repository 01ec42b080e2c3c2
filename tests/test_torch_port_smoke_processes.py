"""``chip_smoke.py`` stops every process it starts.

A JPEG ``AsyncImageReader`` (the smoke's phase 12) leaves multiprocessing's
forkserver and resource tracker running after its pool has shut down, and
they exit only some time after their parent has.  ``stop_child_processes``
stops both and kills any other process still below the smoke; these tests
run it in a fresh interpreter on the CPU and look for what is left once
that interpreter has exited.  Without a GPU the smoke exits non-zero with
no result, also from a directory that holds nothing else of the repo.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JPEGS = sorted((ROOT / "tests" / "data" / "jpeg").glob("*.jpg"))[:2]

SCRIPT = textwrap.dedent("""
    import json, os, subprocess, sys
    sys.path.insert(0, {root!r})
    import chip_smoke
    from cfgpp_tpu_torch.utils.img import AsyncImageReader

    def main():
        with AsyncImageReader({paths!r}) as reader:
            shapes = [img.shape for img in reader]
        stray = subprocess.Popen(["sleep", "60"]) if {stray!r} else None
        before = chip_smoke.descendants(os.getpid())
        killed = chip_smoke.stop_child_processes()
        after = chip_smoke.descendants(os.getpid())
        print(json.dumps({{"shapes": shapes, "before": before,
                          "killed": killed, "after": after}}))

    if __name__ == "__main__":
        try:
            main()
        finally:
            chip_smoke.stop_child_processes()
""")


def run_script(tmp_path: Path, stray: bool) -> dict:
    script = tmp_path / "reader.py"
    script.write_text(SCRIPT.format(root=str(ROOT), stray=stray,
                                    paths=[str(p) for p in JPEGS]))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "leaked" not in out.stderr, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def alive(pid: int) -> bool:
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def test_jpeg_reader_processes_are_stopped(tmp_path):
    rec = run_script(tmp_path, stray=False)
    assert len(rec["shapes"]) == len(JPEGS)
    # the forkserver and the resource tracker were running after the reader
    # closed; they are gone before the interpreter exits, not some time after
    assert len(rec["before"]) >= 2
    assert rec["killed"] == [] and rec["after"] == []
    assert [pid for pid in rec["before"] if alive(pid)] == []


def test_a_stray_child_is_killed(tmp_path):
    rec = run_script(tmp_path, stray=True)
    assert [cmd.split()[:2] for cmd in rec["killed"]] == [["sleep", "60"]]
    assert rec["after"] == []
    assert [pid for pid in rec["before"] if alive(pid)] == []


def test_no_gpu_no_result(tmp_path):
    for where in (ROOT, tmp_path):
        if where == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=where,
                             capture_output=True, text=True, timeout=300,
                             env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
