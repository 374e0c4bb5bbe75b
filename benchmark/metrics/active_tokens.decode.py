"""Mean alive tokens per utterance-frame after each frame's rounds: the
decoder's `last_active_sum` over the real utterances' frames (a count)."""


def read(run):
    c = run["counters"]
    if not c.get("real_frames"):
        return None
    return c["active_sum"] / c["real_frames"]
