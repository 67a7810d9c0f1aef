"""The three-term roofline on the H100 (analysis.py) and one step's
counted costs (step_costs.py)."""
