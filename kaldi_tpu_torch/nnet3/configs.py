"""TDNN and LSTM config generation (the steps/nnet3/make_tdnn_configs.py
and steps/nnet3/lstm/make_configs.py roles).

A copy of kaldi_tpu/nnet3/configs.py (host code): the same strings, byte
for byte, so a config feeds either package's `Nnet3`.
"""

from __future__ import annotations


def make_tdnn_config(
    feat_dim: int,
    num_targets: int,
    splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (-3, 3), (0,)),
    hidden_dim: int = 512,
    nonlinearity: str = "RectifiedLinearComponent",
    pnorm_output_dim: int | None = None,
    final_logsoftmax: bool = True,
) -> str:
    """-> nnet3 config text for a multisplice TDNN.

    nonlinearity="PnormComponent" reduces hidden_dim -> pnorm_output_dim
    per layer (default hidden_dim // 8, the reference's group-of-8), like
    make_tdnn_configs.py's --pnorm-input-dim/--pnorm-output-dim pair.
    """
    is_pnorm = nonlinearity == "PnormComponent"
    if is_pnorm and pnorm_output_dim is None:
        pnorm_output_dim = max(hidden_dim // 8, 1)
    nonlin_out = pnorm_output_dim if is_pnorm else hidden_dim
    lines = [f"input-node name=input dim={feat_dim}"]
    prev, prev_dim = "input", feat_dim
    for li, ctx in enumerate(splice_indexes):
        in_dim = prev_dim * len(ctx)
        desc = ("Append(%s)" % ", ".join(
            prev if o == 0 else f"Offset({prev},{o})" for o in ctx)
            if len(ctx) > 1 else
            (prev if ctx[0] == 0 else f"Offset({prev},{ctx[0]})"))
        nonlin_cfg = (f"input-dim={hidden_dim} output-dim={nonlin_out}"
                      if is_pnorm else f"dim={hidden_dim}")
        lines += [
            f"component name=tdnn{li}.affine "
            f"type=NaturalGradientAffineComponent "
            f"input-dim={in_dim} output-dim={hidden_dim}",
            f"component-node name=tdnn{li}.affine_node "
            f"component=tdnn{li}.affine input={desc}",
            f"component name=tdnn{li}.nonlin type={nonlinearity} "
            f"{nonlin_cfg}",
            f"component-node name=tdnn{li} component=tdnn{li}.nonlin "
            f"input=tdnn{li}.affine_node",
            f"component name=tdnn{li}.norm type=NormalizeComponent "
            f"dim={nonlin_out}",
            f"component-node name=tdnn{li}n component=tdnn{li}.norm "
            f"input=tdnn{li}",
        ]
        prev, prev_dim = f"tdnn{li}n", nonlin_out
    lines += [
        f"component name=final.affine type=NaturalGradientAffineComponent "
        f"input-dim={prev_dim} output-dim={num_targets}",
        f"component-node name=final.affine_node component=final.affine "
        f"input={prev}",
    ]
    if final_logsoftmax:
        lines += [
            f"component name=final.log type=LogSoftmaxComponent "
            f"dim={num_targets}",
            "component-node name=final.log_node component=final.log "
            "input=final.affine_node",
            "output-node name=output input=final.log_node",
        ]
    else:
        lines.append("output-node name=output input=final.affine_node")
    return "\n".join(lines) + "\n"


def make_lstm_config(
    feat_dim: int,
    num_targets: int,
    cell_dim: int = 64,
    proj_dim: int = 32,
    num_layers: int = 1,
    delay: int = -1,
    splice=(-2, -1, 0, 1, 2),
    final_logsoftmax: bool = True,
) -> str:
    """-> nnet3 config text for a projected LSTM built from primitives.

    (ref: egs/wsj/s5/steps/nnet3/lstm/make_configs.py — the reference
     builds LSTMs from config-language pieces: gate affines over
     Append(input, IfDefined(Offset(r, delay))), ElementwiseProduct for
     gate application, NoOp accumulators, a recurrent projection. The
     recurrences c_t = f*c_{t-1} + i*g and the projection loop go
     through IfDefined(Offset(., delay)) exactly as in the reference,
     so the net exercises the scan executor.)
    """
    lines = [f"input-node name=input dim={feat_dim}"]
    prev, prev_dim = "input", feat_dim
    if splice and len(splice) > 1:
        desc = "Append(%s)" % ", ".join(
            "input" if o == 0 else f"Offset(input, {o})" for o in splice)
        lines += [
            f"component name=splice0 type=NoOpComponent "
            f"dim={feat_dim * len(splice)}",
            f"component-node name=spliced component=splice0 input={desc}",
        ]
        prev, prev_dim = "spliced", feat_dim * len(splice)
    for li in range(num_layers):
        p = f"lstm{li}"
        gate_in = (f"Append({prev}, "
                   f"IfDefined(Offset({p}.r, {delay})))")
        in_dim = prev_dim + proj_dim
        for gate, nonlin in (("i", "SigmoidComponent"),
                             ("f", "SigmoidComponent"),
                             ("o", "SigmoidComponent"),
                             ("g", "TanhComponent")):
            lines += [
                f"component name={p}.W_{gate} "
                f"type=NaturalGradientAffineComponent "
                f"input-dim={in_dim} output-dim={cell_dim}",
                f"component-node name={p}.{gate}_pre "
                f"component={p}.W_{gate} input={gate_in}",
                f"component name={p}.{gate}_nl type={nonlin} "
                f"dim={cell_dim}",
                f"component-node name={p}.{gate} component={p}.{gate}_nl "
                f"input={p}.{gate}_pre",
            ]
        lines += [
            f"component name={p}.prod_fc type=ElementwiseProductComponent "
            f"input-dim={2 * cell_dim} output-dim={cell_dim}",
            f"component-node name={p}.fc component={p}.prod_fc "
            f"input=Append({p}.f, IfDefined(Offset({p}.c, {delay})))",
            f"component name={p}.prod_ig type=ElementwiseProductComponent "
            f"input-dim={2 * cell_dim} output-dim={cell_dim}",
            f"component-node name={p}.ig component={p}.prod_ig "
            f"input=Append({p}.i, {p}.g)",
            f"component name={p}.c_acc type=NoOpComponent dim={cell_dim}",
            f"component-node name={p}.c component={p}.c_acc "
            f"input=Sum({p}.fc, {p}.ig)",
            f"component name={p}.c_nl type=TanhComponent dim={cell_dim}",
            f"component-node name={p}.ct component={p}.c_nl input={p}.c",
            f"component name={p}.prod_m type=ElementwiseProductComponent "
            f"input-dim={2 * cell_dim} output-dim={cell_dim}",
            f"component-node name={p}.m component={p}.prod_m "
            f"input=Append({p}.o, {p}.ct)",
            f"component name={p}.W_r type=NaturalGradientAffineComponent "
            f"input-dim={cell_dim} output-dim={proj_dim}",
            f"component-node name={p}.r component={p}.W_r input={p}.m",
        ]
        prev, prev_dim = f"{p}.r", proj_dim
    lines += [
        f"component name=final.affine type=NaturalGradientAffineComponent "
        f"input-dim={prev_dim} output-dim={num_targets}",
        f"component-node name=final.affine_node component=final.affine "
        f"input={prev}",
    ]
    if final_logsoftmax:
        lines += [
            f"component name=final.lsm type=LogSoftmaxComponent "
            f"dim={num_targets}",
            f"component-node name=final.out component=final.lsm "
            f"input=final.affine_node",
            "output-node name=output input=final.out",
        ]
    else:
        lines.append("output-node name=output input=final.affine_node")
    return "\n".join(lines)
