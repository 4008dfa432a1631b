"""Dataset substrate (numpy copies of ``repro.data``): the synthetic
analogues of the paper's three datasets and the preparation steps the
scenarios use."""
from repro_torch.data.metrics import roc_auc
from repro_torch.data.pipeline import (
    anomaly_eval_arrays,
    class_subset,
    normalize_minmax,
    train_test_split,
)
from repro_torch.data.synthetic import (
    DATASETS,
    AnomalyDataset,
    make_dataset,
    make_driving_dataset,
    make_har_dataset,
    make_mnist_like_dataset,
)

__all__ = [
    "roc_auc",
    "anomaly_eval_arrays", "class_subset", "normalize_minmax", "train_test_split",
    "DATASETS", "AnomalyDataset", "make_dataset", "make_driving_dataset",
    "make_har_dataset", "make_mnist_like_dataset",
]
