"""Steps of the window that the Trainer ran eagerly, out of all its steps:
the steps with maintenance due (densify, prune, opacity reset) and any
epoch the Trainer switched back to per-step mode. The harness counts the
steps; ``Graph.replays`` counts the replays."""

LAYER = "Trainer (train/trainer.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "train_steps_per_s"


def read(r):
    if not r.get("steps"):
        return None
    return 100.0 * r["eager_steps"] / r["steps"]
