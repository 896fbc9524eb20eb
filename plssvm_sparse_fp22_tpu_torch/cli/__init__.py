"""Command-line tools: ``plssvm-train-torch``, ``plssvm-predict-torch``,
``plssvm-detect-torch`` and ``plssvm-generate-data-torch``."""
