"""Utility subsystems: assertions."""
