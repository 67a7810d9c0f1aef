"""The paper's tables, the roofline report and Fig. 4 on the port (twins
of the reference's ``benchmarks/table*.py``, ``roofline_report.py`` and
``run.py``), priced on the H100 targets of core/hardware_model.py.

    python -m repro_torch.tables.run [table1 table3 ...] [--device cpu]
"""
