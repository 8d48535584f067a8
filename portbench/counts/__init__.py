"""Operation and byte counts of the program's work, and the card's peaks:
the yardstick of the roofline and MFU metrics, kept with the benchmark (a
served LM's FLOPs are its architecture module's, ``portbench/archs``)."""
