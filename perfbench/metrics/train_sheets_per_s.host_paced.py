"""Training sheets a second over the whole untraced window, as
``train_sheets_per_s`` takes them, in a cell whose step is paced by the
host's Python and launches: there the rate follows the speed of the
machine's shared cores, from run to run, and is read here, per layer."""


def read(run: dict):
    if run["kind"] != "train" or not run["steps"]:
        return None
    return run["sheets_per_s"]
