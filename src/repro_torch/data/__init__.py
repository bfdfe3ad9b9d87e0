"""The deterministic token pipeline that feeds the Trainer."""
