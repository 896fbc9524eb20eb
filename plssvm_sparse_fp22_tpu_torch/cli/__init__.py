"""Command-line tools: ``plssvm-train-torch`` and ``plssvm-predict-torch``."""
