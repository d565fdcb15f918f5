"""Core PTQ library: linear quantization, clipping, and Outlier Channel Splitting."""
from .quantizer import (  # noqa: F401
    QuantParams,
    compute_scale,
    dequantize,
    fake_quant,
    qmax,
    quantize_int,
    quantize_tensor,
    storage_dtype,
)
from .histogram import ChannelStats, StreamingHistogram  # noqa: F401
from .clipping import CLIP_METHODS, aciq_clip, find_clip, kl_clip, mse_clip  # noqa: F401
from .ocs import (  # noqa: F401
    OCSQuantLinear,
    OCSSpec,
    W4A8Linear,
    collapse_expanded,
    duplicate_weight_rows,
    expand_activations,
    expanded_channels,
    fold_expansion_mult,
    make_ocs_quant_linear,
    n_splits_for_ratio,
    oracle_expand,
    split_activations_spec,
    split_weights,
    to_w4a8,
)
from .recipe import QuantRecipe  # noqa: F401
from .allocate import knapsack_allocate, range_reduction_curve  # noqa: F401
from .apply import (  # noqa: F401
    act_scales_from_collector,
    fake_quantize_params,
    knapsack_splits,
    quantize_params,
)
from .actquant import ActQuantCtx, act_quant_ctx, post_ocs_clip  # noqa: F401
