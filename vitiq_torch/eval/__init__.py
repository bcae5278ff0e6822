"""Evaluation: predictions, confusion matrices, the classification report and
its parser, plots and the cross-arm comparison (counterpart of
`vitiq/eval`)."""

from vitiq_torch.eval.evaluate import (  # noqa: F401
    TARGET_SNRS,
    confusion_artifacts,
    evaluate_feed_with_confusion,
    predict_feed,
)
from vitiq_torch.eval.report import (  # noqa: F401
    ClassificationReportParser,
    confusion_matrix,
    write_classification_report,
)
from vitiq_torch.eval.compare import ModelComparison  # noqa: F401
