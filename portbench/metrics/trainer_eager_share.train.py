"""Steps of the window that the Trainer ran eagerly, out of all its steps,
as the program counts them: the adds of ``trainer.steps_eager_maintenance``
and ``trainer.steps_eager_per_step`` over those of the three step counters
(``train/trainer.py``, one add each an epoch), taken over the window's
epochs (``epochs``), before the traced epoch. The in-program twin of
``eager_step_share.train``. Nothing where the program keeps no such
counters or history."""

import sys

LAYER = "Trainer (train/trainer.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "train_steps_per_s"

COUNTERS = ("trainer.steps_replayed", "trainer.steps_eager_maintenance",
            "trainer.steps_eager_per_step")


def read(r):
    history = getattr(sys.modules.get("fateavatar_tpu_torch.utils.profiling"), "history", None)
    k = r.get("epochs")
    if history is None or not k:
        return None
    # the traced epoch, where the run made one, came after the window's
    after = 1 if "trace_replays" in r else 0
    adds = []
    for name in COUNTERS:
        h = history(name)
        if len(h) < k + after:
            return None
        adds.append(sum(h[len(h) - k - after:len(h) - after]))
    total = sum(adds)
    return 100.0 * (adds[1] + adds[2]) / total if total else None
