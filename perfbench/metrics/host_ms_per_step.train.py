"""Host milliseconds a training step: the benchmark's span around each
``train_epoch`` call of the untraced window, summed, over the steps taken.
The host's enqueue time (gather, step, launches); where the device is the
bottleneck the launch queue fills and this tracks the step's wall."""


def read(run: dict):
    if run["kind"] != "train" or not run["steps"]:
        return None
    return 1e3 * run["host_s"] / run["steps"]
