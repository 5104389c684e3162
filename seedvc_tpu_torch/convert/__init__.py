from seedvc_tpu_torch.convert.torch_utils import (  # noqa: F401
    bn_params,
    conv1d_kernel,
    conv2d_kernel,
    fold_weight_norm,
    linear_kernel,
    load_safetensors,
)
