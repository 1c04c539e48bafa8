"""GiB of T the program saved for its backwards (the saved-T counter of
sgrt_tpu_torch.utils.trace, which counts while a profiler records) in the
dense fit's traced window, per completed step. None for a program without
the counter."""

from benchmark import program_trace


def read(run):
    saved_t = getattr(program_trace._trace(), "saved_t", None)
    if run.trace is None or saved_t is None or not run.record["completed"]:
        return None
    return saved_t()[0] / run.record["completed"] / 2 ** 30
