"""Share of the attention's score slots that the slice's steps computed
for no real pair (%): 100 x (1 - real pairs / slots), from the program's
counters (models/modernbert.py's attn_local_key_slots_total,
attn_global_key_slots_total and attn_real_pairs_total) read before and
after the slice.  Real pairs lie inside the window (local layers) and
between real tokens; slots are what the banded local path and the global
layers score, padding included.  It is the work that unpadding or a
tighter band would save, and reads about 100 where the local layers
score densely.  None where the program keeps no such counters."""


def read(data):
    attn = data.get("attn")
    if not attn or attn["local"] + attn["global"] <= 0:
        return None
    return 100.0 * (1.0 - attn["real"] / (attn["local"] + attn["global"]))
