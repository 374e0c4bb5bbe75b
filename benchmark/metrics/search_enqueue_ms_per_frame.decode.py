"""Milliseconds per loop frame that the host spends in the search's frame
loop: the program's `csr_beam.frame_loop` spans in the window (they hold
no synchronize, so they time the enqueue of the loop's device work, and
any wait for room in the launch queue) over their `frames`."""

from program_spans import program_spans, seconds, total


def read(run):
    loops = program_spans(run, "csr_beam.frame_loop")
    frames = total(loops or [], "frames")
    if not frames:
        return None
    return 1e3 * seconds(loops) / frames
