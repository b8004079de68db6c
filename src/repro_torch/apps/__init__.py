"""Application substrate for application-specific AxO DSE (paper Table 2).

Counterpart of ``repro/apps``.  Each application evaluates one BEHAV metric
for a batch of approximate-operator configs; PPA stays the operator's PDPLUT.
The datasets are deterministic procedural surrogates with the task structure
of the paper's: 1-D conv ECG peak detection, GEMV digit classification, 2-D
conv Gaussian smoothing, and a beyond-paper transformer-FFN block.

Every application evaluates through the torch engine of
:mod:`repro_torch.apps.fastapp` (``backend=None``, the card, or an
``ExecutionContext``) and through the numpy oracle (``backend="numpy"``).
"""

from .base import (
    AxOApplication,
    characterized_dataset_multi,
    quantize_int8,
    table_conv1d,
    table_conv2d,
    table_matmul,
)
from .ecg import ECGPeakDetection
from .ffn import TransformerFFN
from .gauss import GaussianSmoothing
from .mnist import DigitClassification

APPLICATIONS = {
    "ecg": ECGPeakDetection,
    "mnist": DigitClassification,
    "gauss": GaussianSmoothing,
    "ffn": TransformerFFN,
}

__all__ = [
    "AxOApplication",
    "APPLICATIONS",
    "ECGPeakDetection",
    "DigitClassification",
    "GaussianSmoothing",
    "TransformerFFN",
    "characterized_dataset_multi",
    "quantize_int8",
    "table_conv1d",
    "table_conv2d",
    "table_matmul",
]
