"""Utility subsystems: assertions, timers and the numpy oracle."""
