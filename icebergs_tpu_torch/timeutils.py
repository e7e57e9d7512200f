"""Date helpers.

Counterpart of ``icebergs_tpu/timeutils.py`` (port of
``offset_berg_dates``, icebergs_framework.F90:1715-1757, and ``yearday``,
4431-4443): model time is a (year, yearday) pair.
"""

from __future__ import annotations

import torch


def yearday(month, day, hour, minute):
    """Day of year in the driver's 30-day-month calendar (yearday,
    icebergs_framework.F90:4431-4443)."""
    return (month - 1) * 30. + day + (hour + minute / 60.) / 24.


def offset_berg_dates(st, current_year, current_yearday):
    """Shift every live berg's birthday back by the largest offset into
    the future found (offset_berg_dates: a restart on an earlier model
    date).  On the device, with no host sync."""
    date = st.start_year.to(st.dtype) * 1000. + st.start_day
    now = current_year * 1000. + current_yearday
    latest = torch.where(st.alive, date, float("-inf")).max()
    off = latest - now
    need = off > 0.
    yr_shift = torch.floor(off / 1000.)
    day_shift = off - 1000. * yr_shift
    new_year = st.start_year - yr_shift.to(torch.int32)
    new_day = st.start_day - day_shift
    # borrow a year where the day went negative
    borrow = new_day < 0.
    new_year = torch.where(borrow, new_year - 1, new_year)
    new_day = torch.where(borrow, new_day + 360., new_day)
    upd = need & st.alive
    return st.replace(start_year=torch.where(upd, new_year, st.start_year),
                      start_day=torch.where(upd, new_day, st.start_day))
