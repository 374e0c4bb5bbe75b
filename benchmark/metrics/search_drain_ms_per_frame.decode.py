"""Milliseconds per loop frame that the host spends fetching the search's
outputs: the program's `hostpack.fetch_host` spans in the window (the
pack, the wait for the card to drain what the loop enqueued, the one
copy) over the `frames` of the window's `csr_beam.frame_loop` spans."""

from program_spans import program_spans, seconds, total


def read(run):
    loops = program_spans(run, "csr_beam.frame_loop")
    fetches = program_spans(run, "hostpack.fetch_host")
    frames = total(loops or [], "frames")
    if not frames or not fetches:
        return None
    return 1e3 * seconds(fetches) / frames
