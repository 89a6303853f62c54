"""Splitting a sweep across processes."""
