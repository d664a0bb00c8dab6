"""The port's training driver (``repro_torch.launch.train``) on the CPU,
mirroring ``tests/test_integration.py``'s training tests: the loss
decreases with the OCF dedup active, a run killed by an injected failure
resumes from its last checkpoint, and ``run_with_restarts`` drives the
restarts; besides, a resumed run replays the data pipeline, so its steps
see the batches of an uninterrupted run and give its losses."""
import numpy as np
import pytest

from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.distributed.fault import RestartPolicy, run_with_restarts
from repro_torch.launch.train import main, train

pytestmark = pytest.mark.tier1


def test_train_loop_loss_decreases(tmp_path):
    out = train("gemma2_27b", steps=12, batch=4, seq=64, smoke=True,
                ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=5, device="cpu")
    losses = [h["loss"] for h in out["history"]]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), "loss must decrease"
    assert out["pipeline_stats"].docs_deduped > 0, "OCF dedup active"
    assert out["pipeline_stats"].batches == 12
    assert latest_step(str(tmp_path / "ckpt")) == 10


def test_checkpoint_restart_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="injected"):
        train("mistral_nemo_12b", steps=10, batch=2, seq=32, smoke=True,
              ckpt_dir=ckpt, ckpt_every=2, inject_failure_at=7, device="cpu")
    assert latest_step(ckpt) == 6
    out = train("mistral_nemo_12b", steps=10, batch=2, seq=32, smoke=True,
                ckpt_dir=ckpt, ckpt_every=2, resume=True, device="cpu")
    assert len(out["history"]) == 4, "resumed from step 6, ran 6..10"
    assert int(out["opt_state"].step) == 10


def test_resumed_steps_match_an_uninterrupted_run(tmp_path):
    """Parameters and AdamW state restored exactly, the pipeline replayed
    through the steps taken: the resumed steps' losses equal the
    uninterrupted run's (float32, the same operations on the CPU)."""
    kw = dict(steps=5, batch=2, seq=32, smoke=True, device="cpu")
    full = train("gemma3_1b", **kw)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="injected"):
        train("gemma3_1b", ckpt_dir=ckpt, ckpt_every=3, inject_failure_at=4,
              **kw)
    resumed = train("gemma3_1b", ckpt_dir=ckpt, ckpt_every=100, **kw)
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in full["history"][3:]]
    assert resumed["pipeline_stats"] == full["pipeline_stats"]


def test_run_with_restarts_helper(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    attempts = []

    def make_state(step):
        return step

    def run_from(state):
        attempts.append(state)
        if len(attempts) < 3:
            return train("gemma3_1b", steps=6, batch=2, seq=32, smoke=True,
                         ckpt_dir=ckpt, ckpt_every=2, device="cpu",
                         inject_failure_at=3 + len(attempts))
        return train("gemma3_1b", steps=6, batch=2, seq=32, smoke=True,
                     ckpt_dir=ckpt, ckpt_every=2, device="cpu")

    out = run_with_restarts(make_state, run_from,
                            RestartPolicy(max_restarts=5, backoff_s=0.0),
                            latest_step_fn=lambda: latest_step(ckpt))
    assert out is not None
    assert len(attempts) == 3
    assert attempts == [None, 4, 4]     # the checkpoints of steps 4, 4


def test_main_cli(capsys):
    main(["--arch", "gemma3-1b", "--smoke", "--steps", "2", "--batch", "2",
          "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "loss: first=" in out and "dedup:" in out
