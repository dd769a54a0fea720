"""The harness of the port's benchmark: registry of cells, seeded content,
the drivers of the measured windows, trace reduction, the roofline's
peaks and byte counts, and the comparison that decides ``correct``."""
