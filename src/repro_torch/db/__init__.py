"""Query front end, TPC-H data and the PimDatabase entry point."""
