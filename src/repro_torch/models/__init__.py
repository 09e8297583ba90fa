"""Dense decoder and encoder LMs of the port (``layers``, ``transformer``,
``model``): the serving side of ``repro.models`` on one device."""
