"""Analytic systolic-array simulator (framework-free copy)."""
