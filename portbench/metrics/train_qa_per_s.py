"""Real rows through train and replay steps in the window ÷ the window
(host clock; the window ends when the card has finished its last
step)."""


def read(rec, cell):
    if "rows" not in rec:
        return None
    return rec["rows"] / rec["window_s"]
