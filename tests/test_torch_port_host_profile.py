"""The host profiler (zett_tpu_torch.tools.host_profile) on a small script:
the script runs as __main__ with its arguments and exit code, and its wall
time lands on the functions that spent it."""

import json

from zett_tpu_torch.tools import host_profile

SCRIPT = '''
import sys
import time


def slow():
    time.sleep(0.3)


def fast():
    time.sleep(0.05)


if __name__ == "__main__":
    slow()
    fast()
    sys.exit(int(sys.argv[1]))
'''


def test_host_profile_attributes_wall_time(tmp_path, capsys):
    script = tmp_path / "script.py"
    script.write_text(SCRIPT)
    out = tmp_path / "prof" / "stacks.json"
    code = host_profile.main(["--out", str(out), "--interval", "5", str(script), "3"])
    assert code == 3
    data = json.loads(out.read_text())
    # every frame under the test's own (pytest's among them)
    inclusive, _ = host_profile.top({tuple(stack): s for stack, s in data["stacks"]}, 1000)
    seconds = {name.split(":")[1]: s for name, s in inclusive if name.startswith("script.py")}
    assert 0.2 < seconds["slow"] < 0.5
    assert seconds["fast"] < seconds["slow"]
    assert seconds["<module>"] >= seconds["slow"] + seconds["fast"] - 0.02
    assert data["wall_s"] >= 0.35
    assert "inclusive seconds" in capsys.readouterr().err
