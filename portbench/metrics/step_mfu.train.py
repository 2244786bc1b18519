"""The training step's share of the card's peak: the step's counted work
(VGG16 to conv4_3 at 224^2, both stacks forward and the prediction's input
gradient, at the bf16 peak; the blend's forward and backward pair work from
the reference's pairs, and FLAME, at the float32 peak; counts/) over the
step's time in the traced replays."""

LAYER = "Step (train/step.py, train/baseline_steps.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_steps_per_s"


def read(r):
    if not r.get("trace_replays") or "ideal_step_s" not in r:
        return None
    return 100.0 * r["ideal_step_s"] / (r["trace_window_s"] / r["trace_replays"])
