"""Workloads: a TaskSpec per task and run_task."""
