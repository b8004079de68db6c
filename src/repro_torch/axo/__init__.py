from .deploy import (
    AXO_LAYERS,
    AxODeployment,
    AxOOperator,
    axo_linear,
    deploy_axo,
    quantize_tensor,
    quantize_weight,
)

__all__ = [
    "AXO_LAYERS",
    "AxODeployment",
    "AxOOperator",
    "axo_linear",
    "deploy_axo",
    "quantize_tensor",
    "quantize_weight",
]
