"""nnet2 compute CLI subcommands of the port.

Counterpart of kaldi_tpu/cli_nnet.py, holding the ported one:
`nnet-am-compute`, the AmNnet forward to an ark on `--device` (default:
cuda). Registered into the main parser by kaldi_tpu_torch.cli.main via
register(sub).

(ref: nnet2bin/nnet-am-compute.cc.)
"""

from __future__ import annotations

import sys

import numpy as np


# ---------------------------------------------------------------- helpers

def _load_am(path, device="cuda"):
    from kaldi_tpu_torch.io.model_io import load_am_nnet
    return load_am_nnet(path, device=device)


# ---------------------------------------------------------------- compute

def _forward_to_ark(am, rspecifier, wspecifier, divide_by_priors: bool,
                    apply_exp: bool = False):
    """Each utterance's features through `am` on its device -> an ark of
    log-posteriors (or pseudo-loglikes, or their exp)."""
    from kaldi_tpu_torch.io.kaldi_io import open_rspecifier, open_wspecifier
    n = 0
    with open_wspecifier(wspecifier) as w:
        for key, feats in open_rspecifier(rspecifier):
            out = (am.loglikes(feats[None])[0] if divide_by_priors
                   else am.log_posteriors(feats[None])[0])
            out = out.cpu().numpy()
            if apply_exp:
                out = np.exp(out)
            w.write(key, out.astype(np.float32))
            n += 1
    return n


def cmd_nnet_am_compute(args):
    """Forward features through an AmNnet, write outputs
    (ref: nnet2bin/nnet-am-compute.cc; --divide-by-priors gives
    pseudo-loglikes, --apply-exp posteriors)."""
    am = _load_am(args.nnet, device=args.device)
    n = _forward_to_ark(am, args.rspecifier, args.wspecifier,
                        args.divide_by_priors, args.apply_exp)
    print(f"nnet-am-compute: {n} utterances", file=sys.stderr)


# ------------------------------------------------------------ registration

def register(sub):
    def add(name, func, *specs):
        q = sub.add_parser(name)
        for spec in specs:
            flags, kw = spec
            q.add_argument(flags, **kw)
        q.set_defaults(func=func)
        return q

    def a(flags, **kw):
        return (flags, kw)

    add("nnet-am-compute", cmd_nnet_am_compute,
        a("nnet"), a("rspecifier"), a("wspecifier"),
        a("--divide-by-priors", action="store_true"),
        a("--apply-exp", action="store_true"),
        a("--device", default="cuda", help="torch device (default: cuda)"))
