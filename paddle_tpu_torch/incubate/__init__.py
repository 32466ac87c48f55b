"""Incubating APIs of the port: the MultiSlot data-generator authoring
API (``data_generator``), the producer half of the dataset plane."""
