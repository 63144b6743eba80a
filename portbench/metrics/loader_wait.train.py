"""Host seconds blocked in ``next()`` on the train and replay loaders
(``data/partition.py``: BatchLoader, collate) ÷ the window, in %."""


def read(rec, cell):
    if "loader_s" not in rec:
        return None
    return 100.0 * rec["loader_s"] / rec["window_s"]
