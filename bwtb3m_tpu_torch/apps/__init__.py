"""The applications over an FM index: probeScanDna and allHamDna."""
