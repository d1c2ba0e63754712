"""Multi-frame TactileSR (MTSR) training entry with the trunk transfer:

    python -m tactilesr_torch.tasks.sr_seqs_task [-c cfg.yaml] [--<key> value ...]

trains ``config.tactileSeqs_config`` (seqsCnt 7) on the SeqsDataset that
``python -m tactilesr_torch.data.generate seqs`` writes, warm-starting the
pattern and force trunks from the STSR ``.pth`` at ``load_checkpoint_dir``
(the counterpart of ``train/tactileSRSeqs_train.py``).  The recipe is
``tasks/sr_task.py``'s with ``seqs=True``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..runtime.hooks import HookBase
from . import sr_task


def main(config=None, mesh=None, max_epochs: Optional[int] = None, auto_resume: bool = False,
         hooks: Sequence[HookBase] = ()) -> sr_task.SRTrainer:
    """``sr_task.main(config, seqs=True, ...)``: the MTSR recipe, over
    ``mesh`` or the config's ``data_parallel``."""
    return sr_task.main(config, seqs=True, mesh=mesh, max_epochs=max_epochs,
                        auto_resume=auto_resume, hooks=hooks)


def _cli(argv=None, hooks: Sequence[HookBase] = ()) -> sr_task.SRTrainer:
    return sr_task._cli(argv, seqs=True, hooks=hooks)


if __name__ == "__main__":
    _cli()
