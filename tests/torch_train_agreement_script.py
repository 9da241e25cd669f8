"""The train launcher on a mesh where only one rank sees a sustained
straggler (after step 1) or a SIGTERM (during step 3): every rank must
take part in each snapshot's gathers, or the run hangs.

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 tests/torch_train_agreement_script.py \\
        --device cpu --model-par 2 --steps 6 --ckpt-every 0 --ckpt-dir DIR

Run by ``tests/test_torch_multirank.py``.  The arguments are the
launcher's.  Expected: a straggler snapshot at step 2, a preemption
snapshot at step 4 (``{"preempted": true}``), and every rank exiting
with 128 + SIGTERM.
"""
import os
import signal
import sys

from repro_torch.distributed import StragglerMonitor
from repro_torch.launch import train

RANK = int(os.environ["RANK"])


class OneRankMonitor(StragglerMonitor):
    """Rank 1 alone: a sustained straggler after step 1, and a SIGTERM
    to itself during step 3."""
    last_step = -1

    def stop(self, step):
        self.last_step = step
        if RANK == 1 and step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return super().stop(step)

    @property
    def should_checkpoint(self) -> bool:
        return RANK == 1 and self.last_step == 1


if __name__ == "__main__":
    # ranks that disagree hang in a collective: end them (SIGALRM's
    # default action) well inside the test's own limit
    signal.alarm(90)
    train.StragglerMonitor = OneRankMonitor
    sys.exit(train.main(sys.argv[1:]))
