from sejonggo_torch.utils.metrics import MetricsLogger, Timer, setup_logging
