// Native render scheduler runtime.
//
// This framework's equivalent of the reference's C++ host scheduler
// (`Program.cpp:107-299`): the square-spiral tile walk from the grid centre
// and the progressive work queue that drives it — finite mode (all spp of a
// tile, then advance, `Program.cpp:237-299`) and endless mode (samples==0:
// one sample per tile per pass, `Program.cpp:184-236`), with cancellation
// preserving progress (Escape semantics, `Program.cpp:188-194`).
//
// The Python driver (`render/tiles.py`) uses this through ctypes when built
// and falls back to an identical pure-Python implementation otherwise; a
// parity test asserts both emit the same schedule.
//
// Build: make -C native  (emits raymarchrenderer/io/_native/libscheduler.so)

#include <cstdint>
#include <cstdlib>

namespace {

// Exact spiral bookkeeping of Program.cpp:203-222 (see tiles.py for the
// line-by-line derivation): off-centre start at ceil(g/2)-1, turn when the
// step count since the last turn reaches the current ring distance.
struct Spiral {
  int gw, gh;
  int x, y, dx, dy;
  int squares, last_squares, dist_count;
  int remaining;

  void init(int w, int h) {
    gw = w;
    gh = h;
    x = (w + 1) / 2 - 1;  // ceil(w/2) - 1
    y = (h + 1) / 2 - 1;
    dx = -1;
    dy = 0;
    squares = 0;
    last_squares = 0;
    dist_count = 0;
    remaining = w * h;
  }

  // Emit the next in-grid tile; returns false when the grid is exhausted.
  bool next(int32_t* out_x, int32_t* out_y) {
    while (remaining > 0) {
      bool in_grid = x >= 0 && x < gw && y >= 0 && y < gh;
      int ex = x, ey = y;
      // advance the walk (Program.cpp:203-222, recentred)
      x -= gw / 2;
      y -= gh / 2;
      if (dist_count * 2 == squares - last_squares) {
        dist_count += 1;
        last_squares = squares;
        int t = dx;
        dx = dy;
        dy = -t;
      } else if (dist_count == squares - last_squares) {
        int t = dx;
        dx = dy;
        dy = -t;
      }
      squares += 1;
      x += dx;
      y += dy;
      x += gw / 2;
      y += gh / 2;
      if (in_grid) {
        remaining -= 1;
        *out_x = ex;
        *out_y = ey;
        return true;
      }
    }
    return false;
  }
};

struct Sched {
  Spiral spiral;
  int gw, gh, spp;  // spp == 0 -> endless mode
  int32_t tx, ty;   // current tile (finite mode)
  int sample;       // next sample within current tile
  int64_t pass;     // pass counter (endless mode)
  bool have_tile;
  bool cancelled;
};

}  // namespace

extern "C" {

// Fill out_xy (2 * gw * gh int32) with the spiral visit order.
// Returns the number of tiles written.
int32_t rmr_spiral_order(int32_t gw, int32_t gh, int32_t* out_xy) {
  if (gw <= 0 || gh <= 0) return 0;
  Spiral s;
  s.init(gw, gh);
  int32_t n = 0, x, y;
  while (s.next(&x, &y)) {
    out_xy[2 * n] = x;
    out_xy[2 * n + 1] = y;
    ++n;
  }
  return n;
}

void* rmr_sched_create(int32_t gw, int32_t gh, int32_t spp) {
  if (gw <= 0 || gh <= 0 || spp < 0) return nullptr;
  Sched* s = static_cast<Sched*>(malloc(sizeof(Sched)));
  if (!s) return nullptr;
  s->spiral.init(gw, gh);
  s->gw = gw;
  s->gh = gh;
  s->spp = spp;
  s->sample = 0;
  s->pass = 0;
  s->have_tile = false;
  s->cancelled = false;
  return s;
}

// Next unit of work: out[0]=tile_x, out[1]=tile_y, out[2]=sample index.
// Returns 1 when out holds work, 0 when the schedule is complete (finite
// mode exhausted, or cancelled).  Endless mode (spp=0) only completes on
// cancel; the per-pass sample index is the pass number (running-mean n).
int32_t rmr_sched_next(void* handle, int32_t* out) {
  Sched* s = static_cast<Sched*>(handle);
  if (!s || s->cancelled) return 0;
  if (s->spp > 0) {
    // finite: all samples of the current tile, then spiral-advance
    if (!s->have_tile || s->sample >= s->spp) {
      if (!s->spiral.next(&s->tx, &s->ty)) return 0;
      s->have_tile = true;
      s->sample = 0;
    }
    out[0] = s->tx;
    out[1] = s->ty;
    out[2] = s->sample++;
    return 1;
  }
  // endless: one sample per tile per pass, restart spiral each pass
  if (!s->spiral.next(&s->tx, &s->ty)) {
    s->spiral.init(s->gw, s->gh);
    s->pass += 1;
    if (!s->spiral.next(&s->tx, &s->ty)) return 0;
  }
  out[0] = s->tx;
  out[1] = s->ty;
  out[2] = static_cast<int32_t>(s->pass);
  return 1;
}

void rmr_sched_cancel(void* handle) {
  Sched* s = static_cast<Sched*>(handle);
  if (s) s->cancelled = true;
}

void rmr_sched_destroy(void* handle) { free(handle); }

}  // extern "C"
