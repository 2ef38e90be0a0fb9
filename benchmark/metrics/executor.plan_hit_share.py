"""executor.plan_hit_share (%): closed loop, the searches over the measured
window that ran a kept plan (the program's `SearchPlanHits` counter) over
those that ran one or planned in full (`SearchPlanHits` +
`SearchPlanMisses`). None where the program counts neither."""


def read(obs):
    c = obs["counters"]
    hits, misses = c.get("SearchPlanHits", 0), c.get("SearchPlanMisses", 0)
    if hits + misses <= 0:
        return None
    return 100.0 * hits / (hits + misses)
