"""The serve CLI of the port on the recurrent decoders against the JAX
package's CLI, on the CPU: ``python -m repro_torch.launch.serve --arch
zamba2_1p2b --smoke --continuous [--paged]`` and the same with ``--arch
xlstm_125m`` print the reference CLI's counter lines on the same flags
(the requests served, decode steps and prefill chunks, occupancy against
the drain-and-refill bound, and paged the block pool's accounting: one
state row a sequence, nothing shared, every block returned).  The prompts
reach 40 tokens, so both CLIs snap them to the scan's quantum of 16.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import re

import pytest

pytest.importorskip("jax")

from repro.launch import serve as RSV  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

FLAGS = ["--smoke", "--continuous", "--device", "cpu", "--requests", "5",
         "--tokens", "5", "--prompt-len", "40", "--slots", "2", "--rate",
         "3.0", "--prefill-chunk", "8", "--shared-prefix", "4"]
_COUNTER_LINES = re.compile(
    r"^((paged )?continuous batching|decode steps|batch occupancy|block "
    r"pool|blocks saved by sharing|prefix cache):.*$", re.M)


@pytest.mark.parametrize("paged", [False, True], ids=["slot_pool", "paged"])
@pytest.mark.parametrize("arch", ["zamba2_1p2b", "xlstm_125m"])
def test_cli_counters_equal_reference_cli(arch, paged, capsys):
    argv = ["--arch", arch] + FLAGS + (["--paged"] if paged else [])
    rc = serve.main(argv)
    mine = capsys.readouterr().out
    rc_ref = RSV.main([a for a in argv if a not in ("--device", "cpu")])
    theirs = capsys.readouterr().out
    assert rc == rc_ref == 0
    lines = [m.group(0) for m in _COUNTER_LINES.finditer(mine)]
    assert len(lines) == (6 if paged else 3)
    assert lines == [m.group(0) for m in _COUNTER_LINES.finditer(theirs)]
    assert "prefill chunks: 5" in mine              # one shot a prompt
    if paged:
        assert "blocks saved by sharing: 0 (prefill tokens reused: 0, " \
            "copy-on-write copies: 0)" in mine
