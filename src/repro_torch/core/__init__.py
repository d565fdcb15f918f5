"""Core PTQ library: linear quantization, clipping, and Outlier Channel Splitting."""
from .quantizer import (  # noqa: F401
    QuantParams,
    compute_scale,
    dequantize,
    qmax,
    quantize_int,
    quantize_tensor,
    storage_dtype,
)
from .histogram import ChannelStats, StreamingHistogram  # noqa: F401
from .clipping import CLIP_METHODS, find_clip, mse_clip  # noqa: F401
from .ocs import (  # noqa: F401
    OCSQuantLinear,
    OCSSpec,
    W4A8Linear,
    expand_activations,
    make_ocs_quant_linear,
    n_splits_for_ratio,
    split_weights,
    to_w4a8,
)
from .recipe import QuantRecipe  # noqa: F401
from .apply import quantize_params  # noqa: F401
