"""Analyses: the structured solid reaction solve."""
