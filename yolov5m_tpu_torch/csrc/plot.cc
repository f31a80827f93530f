// Host rasterizer of the port's prediction images (utils/plotting.py): the
// pixel work of the figures that the JAX package's utils/plotting.py draws
// with matplotlib 3.10 (Agg, FreeType 2.6.1), written out so that the port
// needs neither on any machine.
//
//   plot_glyphs        FreeType's gray rasterizer ("ftgrays": cells of
//                      PIXEL_BITS 8, conics split by their deviation,
//                      nonzero winding) over hinted glyph outlines, put
//                      together into a string's bitmap as FT2Font's
//                      draw_glyphs_to_bitmap does (each glyph's bitmap at
//                      FT_Glyph_To_Bitmap's left and top, or-ed in)
//   plot_path          RendererAgg::draw_path for paths of straight
//                      segments: matplotlib's PathClipper (a path without a
//                      face) and PathSnapper, the face filled and the
//                      stroke (vcgen_stroke: butt or square caps, miter
//                      joins that revert to bevels) rasterized by Agg's
//                      scanline rasterizer (subpixel 8, nonzero), clipped
//                      to a box, blended with matplotlib's
//                      fixed_blender_rgba_plain
//   plot_markers       RendererAgg::draw_markers without a face: a snapped
//                      marker's stroke put at whole pixels (the ticks)
//   plot_text_image    a string's bitmap as coverage of a solid colour
//                      (RendererAgg::draw_text_image at angle 0)
//   plot_resample      imshow's resample of a float32 or float64 RGBA image
//                      through an affine transform: Agg's image_filter_lut
//                      (hanning, 14-bit weights, normalised) with
//                      span_image_resample_rgba_affine, or nearest
//   plot_blend_image   RendererAgg::draw_image: a uint8 RGBA image blended
//                      onto the canvas inside a clip box
//
// Every rule follows the C++ that matplotlib 3.10.8 builds (its Agg 2.4 and
// FreeType 2.6.1), as read from the outputs of that build: the test suite
// holds the figures against matplotlib's, pixel for pixel
// (tests/test_torch_plotting.py). Lines that are neither horizontal nor
// vertical are rasterized by the same cell code but were not held against
// Agg: the figures draw none. The canvas is RGBA, 8 bits a channel, rows
// from the top.
//
// The file turns off floating-point contraction for itself: matplotlib's
// build makes no fused multiply-adds, and a build with -march=native on any
// host must round as it does. data/native.py builds it into one library
// with the port's other host sources. Every function is single-threaded and
// keeps no state between calls.

#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// -- FreeType 2.6.1's gray rasterizer ----------------------------------------

constexpr int PIXEL_BITS = 8;
constexpr long ONE_PIXEL = 1L << PIXEL_BITS;

inline long trunc_px(long x) { return x >> PIXEL_BITS; }
inline long subpixels(long x) { return x << PIXEL_BITS; }
inline long upscale(long x) { return x << (PIXEL_BITS - 6); }

struct Gray {
  long width = 0, height = 0;  // count_ex, count_ey
  // dense cells: column -1 (everything left of the bitmap) .. width - 1
  std::vector<long> area, cover;
  long ex = 0, ey = 0;
  bool invalid = true;
  long x = 0, y = 0;  // current position, upscaled
  long last_ey = 0;   // subpixels(ey) of the current position

  void init(long w, long h) {
    width = w;
    height = h;
    area.assign((w + 1) * h, 0);
    cover.assign((w + 1) * h, 0);
  }
  long* cell_area() { return &area[ey * (width + 1) + ex + 1]; }
  long* cell_cover() { return &cover[ey * (width + 1) + ex + 1]; }

  // accumulates into the current cell; an invalid cell drops what it gets
  long pending_area = 0, pending_cover = 0;
  void record() {
    if (!invalid && (pending_area | pending_cover)) {
      *cell_area() += pending_area;
      *cell_cover() += pending_cover;
    }
  }
  void set_cell(long nex, long ney) {
    if (nex > width) nex = width;
    if (nex < 0) nex = -1;
    if (nex != ex || ney != ey) {
      record();
      pending_area = 0;
      pending_cover = 0;
      ex = nex;
      ey = ney;
    }
    invalid = static_cast<unsigned long>(ey) >= static_cast<unsigned long>(height) ||
              ex >= width;
  }
  void start_cell(long nex, long ney) {
    if (nex > width) nex = width;
    if (nex < 0) nex = -1;
    pending_area = 0;
    pending_cover = 0;
    ex = nex;
    ey = ney;
    invalid = false;
    set_cell(nex, ney);
  }

  void render_scanline(long ey_, long x1, long y1, long x2, long y2) {
    long dx = x2 - x1;
    long ex1 = trunc_px(x1), ex2 = trunc_px(x2);
    long fx1 = x1 - subpixels(ex1), fx2 = x2 - subpixels(ex2);
    if (y1 == y2) {
      set_cell(ex2, ey_);
      return;
    }
    if (ex1 == ex2) {
      long delta = y2 - y1;
      pending_area += (fx1 + fx2) * delta;
      pending_cover += delta;
      return;
    }
    long p = (ONE_PIXEL - fx1) * (y2 - y1);
    long first = ONE_PIXEL;
    long incr = 1;
    if (dx < 0) {
      p = fx1 * (y2 - y1);
      first = 0;
      incr = -1;
      dx = -dx;
    }
    long delta = p / dx;
    long mod = p % dx;
    if (mod < 0) {
      delta--;
      mod += dx;
    }
    pending_area += (fx1 + first) * delta;
    pending_cover += delta;
    ex1 += incr;
    set_cell(ex1, ey_);
    y1 += delta;
    if (ex1 != ex2) {
      p = ONE_PIXEL * (y2 - y1 + delta);
      long lift = p / dx;
      long rem = p % dx;
      if (rem < 0) {
        lift--;
        rem += dx;
      }
      mod -= dx;
      while (ex1 != ex2) {
        delta = lift;
        mod += rem;
        if (mod >= 0) {
          mod -= dx;
          delta++;
        }
        pending_area += ONE_PIXEL * delta;
        pending_cover += delta;
        y1 += delta;
        ex1 += incr;
        set_cell(ex1, ey_);
      }
    }
    delta = y2 - y1;
    pending_area += (fx2 + ONE_PIXEL - first) * delta;
    pending_cover += delta;
  }

  void render_line(long to_x, long to_y) {
    long ey1 = trunc_px(last_ey), ey2 = trunc_px(to_y);
    long fy1 = y - last_ey, fy2 = to_y - subpixels(ey2);
    long dx = to_x - x, dy = to_y - y;
    long mn = std::min(ey1, ey2), mx = std::max(ey1, ey2);
    if (mn >= height || mx < 0) goto End;
    if (ey1 == ey2) {
      render_scanline(ey1, x, fy1, to_x, fy2);
      goto End;
    }
    {
      long incr = 1;
      if (dx == 0) {
        long ex_ = trunc_px(x);
        long two_fx = (x - subpixels(ex_)) << 1;
        long first = ONE_PIXEL;
        if (dy < 0) {
          first = 0;
          incr = -1;
        }
        long delta = first - fy1;
        pending_area += two_fx * delta;
        pending_cover += delta;
        ey1 += incr;
        set_cell(ex_, ey1);
        delta = first + first - ONE_PIXEL;
        long a = two_fx * delta;
        while (ey1 != ey2) {
          pending_area += a;
          pending_cover += delta;
          ey1 += incr;
          set_cell(ex_, ey1);
        }
        delta = fy2 - ONE_PIXEL + first;
        pending_area += two_fx * delta;
        pending_cover += delta;
        goto End;
      }
      long p = (ONE_PIXEL - fy1) * dx;
      long first = ONE_PIXEL;
      if (dy < 0) {
        p = fy1 * dx;
        first = 0;
        incr = -1;
        dy = -dy;
      }
      long delta = p / dy;
      long mod = p % dy;
      if (mod < 0) {
        delta--;
        mod += dy;
      }
      long xx = x + delta;
      render_scanline(ey1, x, fy1, xx, first);
      ey1 += incr;
      set_cell(trunc_px(xx), ey1);
      if (ey1 != ey2) {
        p = ONE_PIXEL * dx;
        long lift = p / dy;
        long rem = p % dy;
        if (rem < 0) {
          lift--;
          rem += dy;
        }
        mod -= dy;
        while (ey1 != ey2) {
          delta = lift;
          mod += rem;
          if (mod >= 0) {
            mod -= dy;
            delta++;
          }
          long x2 = xx + delta;
          render_scanline(ey1, xx, ONE_PIXEL - first, x2, first);
          xx = x2;
          ey1 += incr;
          set_cell(trunc_px(xx), ey1);
        }
      }
      render_scanline(ey1, xx, ONE_PIXEL - first, to_x, fy2);
    }
  End:
    x = to_x;
    y = to_y;
    last_ey = subpixels(ey2);
  }

  void move_to(long tx, long ty) {
    if (!invalid) record();
    long ux = upscale(tx), uy = upscale(ty);
    start_cell(trunc_px(ux), trunc_px(uy));
    x = ux;
    y = uy;
    last_ey = subpixels(trunc_px(uy));
  }

  static void split_conic(long* base) {  // (x, y) pairs
    long a, b;
    base[8] = base[4];
    b = base[2];
    a = base[6] = (base[4] + b) / 2;
    b = base[2] = (base[0] + b) / 2;
    base[4] = (a + b) / 2;
    base[9] = base[5];
    b = base[3];
    a = base[7] = (base[5] + b) / 2;
    b = base[3] = (base[1] + b) / 2;
    base[5] = (a + b) / 2;
  }

  void conic_to(long cx, long cy, long tx, long ty) {
    long stack[2 * (16 * 2 + 1) + 8];
    int levels[32];
    long* arc = stack;
    arc[0] = upscale(tx);
    arc[1] = upscale(ty);
    arc[2] = upscale(cx);
    arc[3] = upscale(cy);
    arc[4] = x;
    arc[5] = y;
    int top = 0;
    long ddx = std::labs(arc[4] + arc[0] - 2 * arc[2]);
    long ddy = std::labs(arc[5] + arc[1] - 2 * arc[3]);
    if (ddx < ddy) ddx = ddy;
    if (ddx < ONE_PIXEL / 4) {
      render_line(arc[0], arc[1]);
      return;
    }
    int level = 0;
    do {
      ddx >>= 2;
      level++;
    } while (ddx > ONE_PIXEL / 4);
    levels[0] = level;
    do {
      level = levels[top];
      if (level > 0) {
        split_conic(arc);
        arc += 4;
        top++;
        levels[top] = levels[top - 1] = level - 1;
        continue;
      }
      render_line(arc[0], arc[1]);
      top--;
      arc -= 4;
    } while (top >= 0);
  }

  // coverage of the bitmap, rows from the top
  void sweep(uint8_t* out) {
    for (long yi = 0; yi < height; ++yi) {
      uint8_t* row = out + (height - 1 - yi) * width;
      long c = cover[yi * (width + 1)];  // column -1
      for (long xi = 0; xi < width; ++xi) {
        long k = yi * (width + 1) + xi + 1;
        c += cover[k];
        long a = c * (ONE_PIXEL * 2) - area[k];
        long cov = a >> (PIXEL_BITS * 2 + 1 - 8);
        if (cov < 0) cov = -cov;
        if (cov >= 256) cov = 255;
        row[xi] = static_cast<uint8_t>(cov);
      }
    }
  }
};

inline long pix_floor(long x) { return x & -64L; }
inline long pix_ceil(long x) { return pix_floor(x + 63); }

}  // namespace

extern "C" {

// The bitmap of a string, as FT2Font::draw_glyphs_to_bitmap makes it.
// Glyph g's outline is entries starts[g] .. starts[g + 1] - 1 of codes
// (matplotlib's path codes: 1 MOVETO, 2 LINETO, 3 CURVE3 as two entries,
// control then end, 79 CLOSEPOLY) and xy (x, y pairs in 26.6, already moved
// by the glyph's pen). bbox_xmin and bbox_ymax are the string's bbox in
// 26.6; out is (h, w), zeroed by the caller.
void plot_glyphs(const uint8_t* codes, const int32_t* xy, const int32_t* starts,
                 int n_glyphs, int bbox_xmin, int bbox_ymax, uint8_t* out, int w,
                 int h) {
  std::vector<uint8_t> bitmap;
  Gray ras;
  for (int g = 0; g < n_glyphs; ++g) {
    int s = starts[g], e = starts[g + 1];
    long xmin = 0, xmax = 0, ymin = 0, ymax = 0;
    bool any = false;
    for (int i = s; i < e; ++i) {
      if (codes[i] == 79) continue;
      long px = xy[2 * i], py = xy[2 * i + 1];
      if (!any) {
        xmin = xmax = px;
        ymin = ymax = py;
        any = true;
      } else {
        xmin = std::min(xmin, px);
        xmax = std::max(xmax, px);
        ymin = std::min(ymin, py);
        ymax = std::max(ymax, py);
      }
    }
    // FT_Glyph_To_Bitmap: the control box grid-fitted, the outline moved
    // to its corner
    xmin = pix_floor(xmin);
    ymin = pix_floor(ymin);
    xmax = pix_ceil(xmax);
    ymax = pix_ceil(ymax);
    long bw = (xmax - xmin) >> 6, bh = (ymax - ymin) >> 6;
    long left = xmin >> 6, top = ymax >> 6;
    if (!any || bw <= 0 || bh <= 0) continue;
    ras.init(bw, bh);
    ras.invalid = true;
    for (int i = s; i < e; ++i) {
      long px = xy[2 * i] - xmin, py = xy[2 * i + 1] - ymin;
      switch (codes[i]) {
        case 1:
          ras.move_to(px, py);
          break;
        case 2:
          ras.render_line(upscale(px), upscale(py));
          break;
        case 3:
          ras.conic_to(px, py, xy[2 * i + 2] - xmin, xy[2 * i + 3] - ymin);
          ++i;
          break;
        default:
          break;
      }
    }
    if (!ras.invalid) ras.record();
    bitmap.assign(bw * bh, 0);
    ras.sweep(bitmap.data());
    // draw_glyphs_to_bitmap's position, then FT2Image::draw_bitmap
    int x = static_cast<int>(left - bbox_xmin * (1. / 64.));
    int y = static_cast<int>(bbox_ymax * (1. / 64.) - top + 1);
    int x1 = std::min(std::max(x, 0), w), y1 = std::min(std::max(y, 0), h);
    int x2 = std::min(std::max(x + static_cast<int>(bw), 0), w);
    int y2 = std::min(std::max(y + static_cast<int>(bh), 0), h);
    int x_start = std::max(0, -x);
    int y_offset = y1 - std::max(0, -y);
    for (int i = y1; i < y2; ++i) {
      uint8_t* dst = out + i * w + x1;
      const uint8_t* src = bitmap.data() + (i - y_offset) * bw + x_start;
      for (int j = x1; j < x2; ++j) *dst++ |= *src++;
    }
  }
}


}  // extern "C"

namespace {

// -- Agg 2.4 as matplotlib builds it ------------------------------------------

inline int iround(double v) { return static_cast<int>((v < 0.0) ? v - 0.5 : v + 0.5); }
inline unsigned uround(double v) { return static_cast<unsigned>(v + 0.5); }
inline int mpl_round_to_int(double v) { return static_cast<int>(v >= 0 ? std::floor(v + 0.5) : std::ceil(v - 0.5)); }

struct Affine {  // agg::trans_affine
  double sx = 1, shy = 0, shx = 0, sy = 1, tx = 0, ty = 0;
  void multiply(const Affine& m) {
    double t0 = sx * m.sx + shy * m.shx;
    double t2 = shx * m.sx + sy * m.shx;
    double t4 = tx * m.sx + ty * m.shx + m.tx;
    shy = sx * m.shy + shy * m.sy;
    sy = shx * m.shy + sy * m.sy;
    ty = tx * m.shy + ty * m.sy + m.ty;
    sx = t0;
    shx = t2;
    tx = t4;
  }
  void transform(double* x, double* y) const {
    double tmp = *x;
    *x = tmp * sx + *y * shx + tx;
    *y = tmp * shy + *y * sy + ty;
  }
  void invert() {
    double d = 1.0 / (sx * sy - shy * shx);
    double t0 = sy * d;
    sy = sx * d;
    shy = -shy * d;
    shx = -shx * d;
    double t4 = -tx * t0 - ty * shx;
    ty = -tx * shy - ty * sy;
    sx = t0;
    tx = t4;
  }
  static Affine from(const double* m) {  // (sx, shy, shx, sy, tx, ty)
    Affine a;
    a.sx = m[0];
    a.shy = m[1];
    a.shx = m[2];
    a.sy = m[3];
    a.tx = m[4];
    a.ty = m[5];
    return a;
  }
  static Affine scaling(double x, double y) {
    Affine a;
    a.sx = x;
    a.sy = y;
    return a;
  }
  static Affine translation(double x, double y) {
    Affine a;
    a.tx = x;
    a.ty = y;
    return a;
  }
};

constexpr unsigned CMD_STOP = 0, CMD_MOVE_TO = 1, CMD_LINE_TO = 2, CMD_END_POLY = 0x0F;
constexpr unsigned FLAG_CLOSE = 0x40;
inline bool is_vertex(unsigned c) { return c >= CMD_MOVE_TO && c < CMD_END_POLY; }
inline bool is_end_poly(unsigned c) { return (c & 0x0F) == CMD_END_POLY; }

struct Vtx {
  double x, y;
  unsigned cmd;
};

// rasterizer_cells_aa + rasterizer_scanline_aa (nonzero, no gamma), cells
// kept in a list and summed per pixel at the sweep
struct AggRas {
  struct Cell {
    int x, y, cover, area;
  };
  std::vector<Cell> cells;
  int cx = 0x7FFFFFFF, cy = 0x7FFFFFFF, ccover = 0, carea = 0;
  double start_x = 0, start_y = 0;
  int last_x = 0, last_y = 0;
  bool has_line = false;

  void flush() {
    if (ccover | carea) cells.push_back({cx, cy, ccover, carea});
  }
  void set_curr_cell(int x, int y) {
    if (cx != x || cy != y) {
      flush();
      cx = x;
      cy = y;
      ccover = 0;
      carea = 0;
    }
  }
  void render_hline(int ey, int x1, int y1, int x2, int y2) {
    int ex1 = x1 >> 8, ex2 = x2 >> 8;
    int fx1 = x1 & 255, fx2 = x2 & 255;
    int delta, p, first, dx, incr, lift, mod, rem;
    if (y1 == y2) {
      set_curr_cell(ex2, ey);
      return;
    }
    if (ex1 == ex2) {
      delta = y2 - y1;
      ccover += delta;
      carea += (fx1 + fx2) * delta;
      return;
    }
    p = (256 - fx1) * (y2 - y1);
    first = 256;
    incr = 1;
    dx = x2 - x1;
    if (dx < 0) {
      p = fx1 * (y2 - y1);
      first = 0;
      incr = -1;
      dx = -dx;
    }
    delta = p / dx;
    mod = p % dx;
    if (mod < 0) {
      delta--;
      mod += dx;
    }
    ccover += delta;
    carea += (fx1 + first) * delta;
    ex1 += incr;
    set_curr_cell(ex1, ey);
    y1 += delta;
    if (ex1 != ex2) {
      p = 256 * (y2 - y1 + delta);
      lift = p / dx;
      rem = p % dx;
      if (rem < 0) {
        lift--;
        rem += dx;
      }
      mod -= dx;
      while (ex1 != ex2) {
        delta = lift;
        mod += rem;
        if (mod >= 0) {
          mod -= dx;
          delta++;
        }
        ccover += delta;
        carea += 256 * delta;
        y1 += delta;
        ex1 += incr;
        set_curr_cell(ex1, ey);
      }
    }
    delta = y2 - y1;
    ccover += delta;
    carea += (fx2 + 256 - first) * delta;
  }
  void line(int x1, int y1, int x2, int y2) {
    int dx = x2 - x1;
    if (dx >= (16384 << 8) || dx <= -(16384 << 8)) {
      int mx = (x1 + x2) >> 1, my = (y1 + y2) >> 1;
      line(x1, y1, mx, my);
      line(mx, my, x2, y2);
      return;
    }
    int dy = y2 - y1;
    int ex1 = x1 >> 8, ex2 = x2 >> 8;
    int ey1 = y1 >> 8, ey2 = y2 >> 8;
    int fy1 = y1 & 255, fy2 = y2 & 255;
    int x_from, x_to, p, rem, mod, lift, delta, first, incr;
    (void)ex2;
    set_curr_cell(ex1, ey1);
    if (ey1 == ey2) {
      render_hline(ey1, x1, fy1, x2, fy2);
      return;
    }
    incr = 1;
    if (dx == 0) {
      int ex = x1 >> 8;
      int two_fx = (x1 - (ex << 8)) << 1;
      int area;
      first = 256;
      if (dy < 0) {
        first = 0;
        incr = -1;
      }
      delta = first - fy1;
      ccover += delta;
      carea += two_fx * delta;
      ey1 += incr;
      set_curr_cell(ex, ey1);
      delta = first + first - 256;
      area = two_fx * delta;
      while (ey1 != ey2) {
        ccover = delta;
        carea = area;
        ey1 += incr;
        set_curr_cell(ex, ey1);
      }
      delta = fy2 - 256 + first;
      ccover += delta;
      carea += two_fx * delta;
      return;
    }
    p = (256 - fy1) * dx;
    first = 256;
    if (dy < 0) {
      p = fy1 * dx;
      first = 0;
      incr = -1;
      dy = -dy;
    }
    delta = p / dy;
    mod = p % dy;
    if (mod < 0) {
      delta--;
      mod += dy;
    }
    x_from = x1 + delta;
    render_hline(ey1, x1, fy1, x_from, first);
    ey1 += incr;
    set_curr_cell(x_from >> 8, ey1);
    if (ey1 != ey2) {
      p = 256 * dx;
      lift = p / dy;
      rem = p % dy;
      if (rem < 0) {
        lift--;
        rem += dy;
      }
      mod -= dy;
      while (ey1 != ey2) {
        delta = lift;
        mod += rem;
        if (mod >= 0) {
          mod -= dy;
          delta++;
        }
        x_to = x_from + delta;
        render_hline(ey1, x_from, 256 - first, x_to, first);
        x_from = x_to;
        ey1 += incr;
        set_curr_cell(x_from >> 8, ey1);
      }
    }
    render_hline(ey1, x_from, 256 - first, x2, fy2);
  }

  // rasterizer_scanline_aa's move_to_d / line_to_d / close_polygon
  // (auto-close); coordinates in pixels
  int sx_i = 0, sy_i = 0;
  bool open = false;
  void close_polygon() {
    if (open) line(last_x, last_y, sx_i, sy_i);
    open = false;
  }
  void move_to(double x, double y) {
    close_polygon();
    sx_i = last_x = iround(x * 256);
    sy_i = last_y = iround(y * 256);
  }
  void line_to(double x, double y) {
    int nx = iround(x * 256), ny = iround(y * 256);
    line(last_x, last_y, nx, ny);
    last_x = nx;
    last_y = ny;
    open = true;
  }
  void add_vertex(const Vtx& v) {
    if (v.cmd == CMD_MOVE_TO)
      move_to(v.x, v.y);
    else if (is_vertex(v.cmd))
      line_to(v.x, v.y);
    else if (is_end_poly(v.cmd) && (v.cmd & FLAG_CLOSE))
      close_polygon();
  }

  // the coverage of each pixel, handed to fn(x, y, alpha) for pixels
  // inside [x1, x2) x [y1, y2)
  template <class F>
  void sweep(int x1, int y1, int x2, int y2, F fn) {
    close_polygon();
    flush();
    cx = cy = 0x7FFFFFFF;
    ccover = carea = 0;
    std::sort(cells.begin(), cells.end(), [](const Cell& a, const Cell& b) {
      return a.y != b.y ? a.y < b.y : a.x < b.x;
    });
    auto alpha_of = [](int area) {
      int cover = area >> 9;
      if (cover < 0) cover = -cover;
      if (cover > 255) cover = 255;
      return cover;
    };
    size_t i = 0, n = cells.size();
    while (i < n) {
      int y = cells[i].y;
      int cover = 0;
      while (i < n && cells[i].y == y) {
        int x = cells[i].x;
        int area = cells[i].area;
        cover += cells[i].cover;
        ++i;
        while (i < n && cells[i].y == y && cells[i].x == x) {
          area += cells[i].area;
          cover += cells[i].cover;
          ++i;
        }
        bool row_in = y >= y1 && y < y2;
        if (area) {
          int a = alpha_of((cover << 9) - area);
          if (a && row_in && x >= x1 && x < x2) fn(x, y, a);
          x++;
        }
        if (i < n && cells[i].y == y && cells[i].x > x) {
          int a = alpha_of(cover << 9);
          if (a && row_in) {
            int xa = std::max(x, x1), xb = std::min(cells[i].x, x2);
            for (int xx = xa; xx < xb; ++xx) fn(xx, y, a);
          }
        }
      }
    }
    cells.clear();
  }
};

struct Rgba8 {
  unsigned r, g, b, a;
};

inline Rgba8 rgba8_of(const double* c) {
  return {uround(c[0] * 255), uround(c[1] * 255), uround(c[2] * 255), uround(c[3] * 255)};
}

// rgba8 multiply: (a * b + 128) rounded by 255
inline unsigned mult_cover(unsigned a, unsigned b) {
  unsigned t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

// matplotlib's fixed_blender_rgba_plain
inline void blend_pix(uint8_t* p, unsigned cr, unsigned cg, unsigned cb, unsigned alpha) {
  if (alpha == 0) return;
  unsigned a = p[3];
  unsigned r = p[0] * a;
  unsigned g = p[1] * a;
  unsigned b = p[2] * a;
  a = ((alpha + a) << 8) - alpha * a;
  p[3] = static_cast<uint8_t>(a >> 8);
  p[0] = static_cast<uint8_t>((((cr << 8) - r) * alpha + (r << 8)) / a);
  p[1] = static_cast<uint8_t>((((cg << 8) - g) * alpha + (g << 8)) / a);
  p[2] = static_cast<uint8_t>((((cb << 8) - b) * alpha + (b << 8)) / a);
}

// pixfmt blend with a coverage: set when opaque and fully covered
inline void blend_cover(uint8_t* p, const Rgba8& c, unsigned cover) {
  if (c.a == 0) return;
  if (c.a == 255 && cover == 255) {
    p[0] = static_cast<uint8_t>(c.r);
    p[1] = static_cast<uint8_t>(c.g);
    p[2] = static_cast<uint8_t>(c.b);
    p[3] = static_cast<uint8_t>(c.a);
  } else {
    blend_pix(p, c.r, c.g, c.b, mult_cover(c.a, cover));
  }
}

// -- vcgen_stroke -------------------------------------------------------------

enum { BUTT = 0, SQUARE = 1 };  // line caps: matplotlib's butt, projecting

struct VD {  // vertex_dist
  double x, y, dist;
  bool operator()(VD& v) {  // sets dist to the next vertex
    dist = std::sqrt((v.x - x) * (v.x - x) + (v.y - y) * (v.y - y));
    bool ret = dist > 1e-14;
    if (!ret) dist = 1.0 / 1e-14;
    return ret;
  }
};

struct VSeq {  // vertex_sequence
  std::vector<VD> v;
  size_t size() const { return v.size(); }
  VD& operator[](size_t i) { return v[i]; }
  void remove_last() {
    if (!v.empty()) v.pop_back();
  }
  void add(const VD& val) {
    if (v.size() > 1) {
      if (!v[v.size() - 2](v[v.size() - 1])) remove_last();
    }
    v.push_back(val);
  }
  void modify_last(const VD& val) {
    remove_last();
    add(val);
  }
  void close(bool closed) {
    while (v.size() > 1) {
      if (v[v.size() - 2](v[v.size() - 1])) break;
      VD t = v[v.size() - 1];
      remove_last();
      modify_last(t);
    }
    if (closed) {
      while (v.size() > 1) {
        if (v[v.size() - 1](v[0])) break;
        remove_last();
      }
    }
  }
  VD& prev(size_t idx) { return v[(idx + v.size() - 1) % v.size()]; }
  VD& curr(size_t idx) { return v[idx]; }
  VD& next(size_t idx) { return v[(idx + 1) % v.size()]; }
};

// math_stroke with matplotlib's joinstyle "miter", which is Agg's
// miter_join_revert: past the miter limit (and at every inner corner past
// the inner limit) a bevel
struct Stroker {
  double width = 0.5, width_abs = 0.5, width_sign = 1;
  double miter_limit = 4, inner_miter_limit = 1.01;
  int cap = BUTT;
  void set_width(double w) {
    width = w * 0.5;
    if (width < 0) {
      width_abs = -width;
      width_sign = -1;
    } else {
      width_abs = width;
      width_sign = 1;
    }
  }
  static double cross(double x1, double y1, double x2, double y2, double x, double y) {
    return (x - x2) * (y2 - y1) - (y - y2) * (x2 - x1);
  }
  static bool intersection(double ax, double ay, double bx, double by, double cx, double cy,
                           double dx, double dy, double* x, double* y) {
    double num = (ay - cy) * (dx - cx) - (ax - cx) * (dy - cy);
    double den = (bx - ax) * (dy - cy) - (by - ay) * (dx - cx);
    if (std::fabs(den) < 1.0e-30) return false;
    double r = num / den;
    *x = ax + r * (bx - ax);
    *y = ay + r * (by - ay);
    return true;
  }
  static double distance(double x1, double y1, double x2, double y2) {
    double dx = x2 - x1, dy = y2 - y1;
    return std::sqrt(dx * dx + dy * dy);
  }
  void cap_of(std::vector<Vtx>& out, const VD& v0, const VD& v1, double len) {
    out.clear();
    double dx1 = (v1.y - v0.y) / len;
    double dy1 = (v1.x - v0.x) / len;
    double dx2 = 0, dy2 = 0;
    dx1 *= width;
    dy1 *= width;
    if (cap == SQUARE) {
      dx2 = dy1 * width_sign;
      dy2 = dx1 * width_sign;
    }
    out.push_back({v0.x - dx1 - dx2, v0.y + dy1 - dy2, 0});
    out.push_back({v0.x + dx1 - dx2, v0.y - dy1 - dy2, 0});
  }
  void miter(std::vector<Vtx>& out, const VD& v0, const VD& v1, const VD& v2, double dx1,
             double dy1, double dx2, double dy2, double mlimit) {
    double xi = v1.x, yi = v1.y;
    double lim = width_abs * mlimit;
    bool exceeded = true;
    if (intersection(v0.x + dx1, v0.y - dy1, v1.x + dx1, v1.y - dy1, v1.x + dx2, v1.y - dy2,
                     v2.x + dx2, v2.y - dy2, &xi, &yi)) {
      if (distance(v1.x, v1.y, xi, yi) <= lim) {
        out.push_back({xi, yi, 0});
        exceeded = false;
      }
    } else {
      double x2 = v1.x + dx1, y2 = v1.y - dy1;
      if ((cross(v0.x, v0.y, v1.x, v1.y, x2, y2) < 0.0) ==
          (cross(v1.x, v1.y, v2.x, v2.y, x2, y2) < 0.0)) {
        out.push_back({v1.x + dx1, v1.y - dy1, 0});
        exceeded = false;
      }
    }
    if (exceeded) {
      out.push_back({v1.x + dx1, v1.y - dy1, 0});
      out.push_back({v1.x + dx2, v1.y - dy2, 0});
    }
  }
  void join_of(std::vector<Vtx>& out, const VD& v0, const VD& v1, const VD& v2, double len1,
               double len2) {
    double dx1 = width * (v1.y - v0.y) / len1;
    double dy1 = width * (v1.x - v0.x) / len1;
    double dx2 = width * (v2.y - v1.y) / len2;
    double dy2 = width * (v2.x - v1.x) / len2;
    out.clear();
    double cp = cross(v0.x, v0.y, v1.x, v1.y, v2.x, v2.y);
    if ((cp > 1e-14 && width > 0) || (cp < -1e-14 && width < 0)) {
      // inner join: inner_miter
      double limit = ((len1 < len2) ? len1 : len2) / width_abs;
      if (limit < inner_miter_limit) limit = inner_miter_limit;
      miter(out, v0, v1, v2, dx1, dy1, dx2, dy2, limit);
    } else {
      miter(out, v0, v1, v2, dx1, dy1, dx2, dy2, miter_limit);
    }
  }
};

// conv_stroke over a vertex source: the stroke outline's vertices, as the
// rasterizer receives them
void stroke_path(const std::vector<Vtx>& src, Stroker& st, std::vector<Vtx>& out) {
  size_t i = 0, n = src.size();
  std::vector<Vtx> ov;
  while (i < n) {
    // accumulate one sub-path (conv_adaptor_vcgen)
    if (src[i].cmd != CMD_MOVE_TO && !is_vertex(src[i].cmd)) {
      ++i;
      continue;
    }
    VSeq seq;
    bool closed = false;
    seq.modify_last({src[i].x, src[i].y, 0});
    ++i;
    while (i < n) {
      const Vtx& v = src[i];
      if (is_vertex(v.cmd)) {
        if (v.cmd == CMD_MOVE_TO) break;
        seq.add({v.x, v.y, 0});
        ++i;
      } else {
        ++i;
        if (is_end_poly(v.cmd)) {
          closed = (v.cmd & FLAG_CLOSE) != 0;
          break;
        }
      }
    }
    // vcgen_stroke::rewind and vertex
    seq.close(closed);
    if (seq.size() < 3) closed = false;
    if (seq.size() < 2 + static_cast<size_t>(closed)) continue;
    unsigned cmd = CMD_MOVE_TO;
    auto emit = [&](const std::vector<Vtx>& vs) {
      for (const Vtx& v : vs) {
        out.push_back({v.x, v.y, cmd});
        cmd = CMD_LINE_TO;
      }
    };
    size_t m = seq.size();
    if (closed) {
      for (size_t k = 0; k < m; ++k) {
        st.join_of(ov, seq.prev(k), seq.curr(k), seq.next(k), seq.prev(k).dist, seq.curr(k).dist);
        emit(ov);
      }
      out.push_back({0, 0, CMD_END_POLY | FLAG_CLOSE});
      cmd = CMD_MOVE_TO;
      for (size_t k = m; k > 0;) {
        --k;
        st.join_of(ov, seq.next(k), seq.curr(k), seq.prev(k), seq.curr(k).dist, seq.prev(k).dist);
        emit(ov);
      }
      out.push_back({0, 0, CMD_END_POLY | FLAG_CLOSE});
    } else {
      st.cap_of(ov, seq[0], seq[1], seq[0].dist);
      emit(ov);
      for (size_t k = 1; k + 1 < m; ++k) {
        st.join_of(ov, seq.prev(k), seq.curr(k), seq.next(k), seq.prev(k).dist, seq.curr(k).dist);
        emit(ov);
      }
      st.cap_of(ov, seq[m - 1], seq[m - 2], seq[m - 2].dist);
      emit(ov);
      for (size_t k = m - 1; k > 1;) {
        --k;
        st.join_of(ov, seq.next(k), seq.curr(k), seq.prev(k), seq.curr(k).dist, seq.prev(k).dist);
        emit(ov);
      }
      out.push_back({0, 0, CMD_END_POLY | FLAG_CLOSE});
    }
  }
}

// agg::clip_line_segment (Liang-Barsky flags): 0 visible, 4 clipped away,
// else bit 0 when the first point moved and bit 1 when the second did
unsigned clip_flags(double x, double y, const double* b) {
  return (x > b[2]) | ((y > b[3]) << 1) | ((x < b[0]) << 2) | ((y < b[1]) << 3);
}

bool clip_move_point(double x1, double y1, double x2, double y2, const double* b, double* x,
                     double* y, unsigned flags) {
  double bound;
  if (flags & 5) {
    if (x1 == x2) return false;
    bound = (flags & 4) ? b[0] : b[2];
    *y = (bound - x1) * (y2 - y1) / (x2 - x1) + y1;
    *x = bound;
  }
  flags = ((*y > b[3]) << 1) | ((*y < b[1]) << 3);
  if (flags & 10) {
    if (y1 == y2) return false;
    bound = (flags & 8) ? b[1] : b[3];
    *x = (bound - y1) * (x2 - x1) / (y2 - y1) + x1;
    *y = bound;
  }
  return true;
}

unsigned clip_line_segment(double* x1, double* y1, double* x2, double* y2, const double* b) {
  unsigned f1 = clip_flags(*x1, *y1, b), f2 = clip_flags(*x2, *y2, b);
  unsigned ret = 0;
  if ((f2 | f1) == 0) return 0;
  if ((f1 & 5) != 0 && (f1 & 5) == (f2 & 5)) return 4;
  if ((f1 & 10) != 0 && (f1 & 10) == (f2 & 10)) return 4;
  double tx1 = *x1, ty1 = *y1, tx2 = *x2, ty2 = *y2;
  if (f1) {
    if (!clip_move_point(tx1, ty1, tx2, ty2, b, x1, y1, f1)) return 4;
    if (*x1 == *x2 && *y1 == *y2) return 4;
    ret |= 1;
  }
  if (f2) {
    if (!clip_move_point(tx1, ty1, tx2, ty2, b, x2, y2, f2)) return 4;
    if (*x1 == *x2 && *y1 == *y2) return 4;
    ret |= 2;
  }
  return ret;
}

// matplotlib's PathClipper over a path of straight segments: each segment
// clipped to the canvas grown by a pixel; a closed path that lost any part
// comes out open (its start and end then get caps, not a join)
std::vector<Vtx> clip_path(const std::vector<Vtx>& src, int W, int H) {
  const double box[4] = {-1.0, -1.0, W + 1.0, H + 1.0};
  std::vector<Vtx> out;
  double last_x = NAN, last_y = NAN, init_x = NAN, init_y = NAN;
  bool moveto = true, has_init = false, was_clipped = false;
  auto draw = [&](double x0, double y0, double x1, double y1, bool closed) {
    unsigned moved = clip_line_segment(&x0, &y0, &x1, &y1, box);
    was_clipped = was_clipped || moved != 0;
    if (moved >= 4) return false;
    if ((moved & 1) || moveto) out.push_back({x0, y0, CMD_MOVE_TO});
    out.push_back({x1, y1, CMD_LINE_TO});
    if (closed && !was_clipped) out.push_back({x1, y1, CMD_END_POLY | FLAG_CLOSE});
    moveto = false;
    return true;
  };
  auto inside = [&](double x, double y) {
    return x >= box[0] && x <= box[2] && y >= box[1] && y <= box[3];
  };
  for (const Vtx& v : src) {
    if (v.cmd == (CMD_END_POLY | FLAG_CLOSE)) {
      if (has_init) draw(last_x, last_y, init_x, init_y, true);
    } else if (v.cmd == CMD_MOVE_TO) {
      bool emit = moveto && has_init && inside(last_x, last_y);
      init_x = last_x = v.x;
      init_y = last_y = v.y;
      has_init = true;
      moveto = true;
      was_clipped = false;
      if (emit) out.push_back({last_x, last_y, CMD_MOVE_TO});
    } else if (v.cmd == CMD_LINE_TO) {
      draw(last_x, last_y, v.x, v.y, false);
      last_x = v.x;
      last_y = v.y;
    }
  }
  if (moveto && has_init && inside(last_x, last_y)) out.push_back({last_x, last_y, CMD_MOVE_TO});
  return out;
}

// PathSnapper: whether to snap (always, or SNAP_AUTO: only horizontal and
// vertical segments), then floor(x + 0.5) + the snap value
bool should_snap(const std::vector<Vtx>& p, bool always) {
  if (always) return true;
  if (p.size() > 1024 || p.empty()) return false;
  double x0 = p[0].x, y0 = p[0].y;
  for (size_t i = 1; i < p.size(); ++i) {
    unsigned c = p[i].cmd;
    if (c == 3 || c == 4) return false;
    if (c == CMD_LINE_TO && std::fabs(x0 - p[i].x) >= 1e-4 && std::fabs(y0 - p[i].y) >= 1e-4)
      return false;
    x0 = p[i].x;
    y0 = p[i].y;
  }
  return true;
}

void snap(std::vector<Vtx>& p, bool always, double stroke_width) {
  if (!should_snap(p, always)) return;
  double value = (mpl_round_to_int(stroke_width) % 2) ? 0.5 : 0.0;
  for (Vtx& v : p) {
    if (is_vertex(v.cmd)) {
      v.x = std::floor(v.x + 0.5) + value;
      v.y = std::floor(v.y + 0.5) + value;
    }
  }
}

std::vector<Vtx> read_path(const double* verts, const uint8_t* codes, int n, const Affine& tr) {
  std::vector<Vtx> p;
  for (int i = 0; i < n; ++i) {
    double x = verts[2 * i], y = verts[2 * i + 1];
    unsigned c = codes ? codes[i] : (i == 0 ? CMD_MOVE_TO : CMD_LINE_TO);
    if (is_vertex(c)) tr.transform(&x, &y);
    p.push_back({x, y, c});
  }
  return p;
}

// set_clipbox: the rasterizer's box from a clip rectangle (x0, y0, x1, y1)
// in matplotlib's pixels (y up)
void clip_box_of(const double* clip, int W, int H, int* box) {
  if (clip && (clip[0] != 0.0 || clip[1] != 0.0 || clip[2] != 0.0 || clip[3] != 0.0)) {
    int x1 = std::max(static_cast<int>(std::floor(clip[0] + 0.5)), 0);
    int y1 = std::max(static_cast<int>(std::floor(H - clip[1] + 0.5)), 0);
    int x2 = std::min(static_cast<int>(std::floor(clip[2] + 0.5)), W);
    int y2 = std::min(static_cast<int>(std::floor(H - clip[3] + 0.5)), H);
    box[0] = std::min(x1, x2);
    box[2] = std::max(x1, x2);
    box[1] = std::min(y1, y2);
    box[3] = std::max(y1, y2);
  } else {
    box[0] = 0;
    box[1] = 0;
    box[2] = W;
    box[3] = H;
  }
}

void fill(uint8_t* canvas, int W, int H, AggRas& ras, const int* box, const Rgba8& c) {
  ras.sweep(box[0], box[1], std::min(box[2], W), std::min(box[3], H),
            [&](int x, int y, int a) { blend_cover(canvas + (static_cast<size_t>(y) * W + x) * 4, c, a); });
}

}  // namespace

extern "C" {

// RendererAgg::draw_path for a path of straight segments: verts (n, 2) and
// codes (matplotlib's, or null for a polyline) through mtx (sx, shy, shx,
// sy, tx, ty: matplotlib's affine), snapped where it is all horizontal
// and vertical segments, its face filled with face (rgba in 0..1, or null),
// then stroked at linewidth lw_pt points (0: no stroke) in stroke with cap
// (0 butt, 1 projecting) and miter joins, both clipped to clip (x0, y0,
// x1, y1 in matplotlib's pixels, or null). The canvas is (H, W, 4).
void plot_path(uint8_t* canvas, int W, int H, double dpi, const double* verts,
               const uint8_t* codes, int n, const double* mtx, const double* face,
               double lw_pt, const double* stroke, int cap, const double* clip) {
  Affine tr = Affine::from(mtx);
  tr.multiply(Affine::scaling(1.0, -1.0));
  tr.multiply(Affine::translation(0.0, static_cast<double>(H)));
  std::vector<Vtx> p = read_path(verts, codes, n, tr);
  if (!face) p = clip_path(p, W, H);  // only a path without a face is clipped
  double lw_px = lw_pt * dpi / 72.0;
  double snapping_lw = (stroke && stroke[3] != 0.0) ? lw_px : 0.0;
  snap(p, false, snapping_lw);
  int box[4];
  clip_box_of(clip, W, H, box);
  AggRas ras;
  if (face) {
    for (const Vtx& v : p) ras.add_vertex(v);
    fill(canvas, W, H, ras, box, rgba8_of(face));
  }
  if (lw_pt != 0.0 && stroke) {
    Stroker st;
    st.set_width(lw_px);
    st.cap = cap;
    st.miter_limit = lw_px;
    std::vector<Vtx> outline;
    stroke_path(p, st, outline);
    for (const Vtx& v : outline) ras.add_vertex(v);
    fill(canvas, W, H, ras, box, rgba8_of(stroke));
  }
}

// RendererAgg::draw_markers without a face: the marker path (through
// marker_mtx, snapped) stroked at lw_pt points with cap, put at each point
// of the path (through mtx) rounded to a pixel.
void plot_markers(uint8_t* canvas, int W, int H, double dpi, const double* marker,
                  int n_marker, const double* marker_mtx, const double* points, int n_points,
                  const double* mtx, double lw_pt, const double* color, int cap) {
  Affine mt = Affine::from(marker_mtx);
  mt.multiply(Affine::scaling(1.0, -1.0));
  Affine tr = Affine::from(mtx);
  tr.multiply(Affine::scaling(1.0, -1.0));
  tr.multiply(Affine::translation(0.5, static_cast<double>(H) + 0.5));
  double lw_px = lw_pt * dpi / 72.0;
  std::vector<Vtx> mp = read_path(marker, nullptr, n_marker, mt);
  snap(mp, true, lw_px);  // the ticks' gc snaps
  Stroker st;
  st.set_width(lw_px);
  st.cap = cap;
  st.miter_limit = lw_px;
  std::vector<Vtx> outline;
  stroke_path(mp, st, outline);
  // the marker's extent in pixels, for the cull of far points
  AggRas probe;
  for (const Vtx& v : outline) probe.add_vertex(v);
  int mx1 = 0x7FFFFFFF, my1 = 0x7FFFFFFF, mx2 = -0x7FFFFFFF, my2 = -0x7FFFFFFF;
  probe.sweep(-0x3FFFFFFF, -0x3FFFFFFF, 0x3FFFFFFF, 0x3FFFFFFF, [&](int x, int y, int) {
    mx1 = std::min(mx1, x);
    my1 = std::min(my1, y);
    mx2 = std::max(mx2, x);
    my2 = std::max(my2, y);
  });
  Rgba8 c = rgba8_of(color);
  int box[4] = {0, 0, W, H};
  for (int i = 0; i < n_points; ++i) {
    double x = points[2 * i], y = points[2 * i + 1];
    tr.transform(&x, &y);
    if (!(std::isfinite(x) && std::isfinite(y))) continue;
    x = std::floor(x);
    y = std::floor(y);
    if (!(x >= -1.0 - mx2 && x <= 1.0 + W - mx1 && y >= -1.0 - my2 && y <= 1.0 + H - my1))
      continue;
    int ox = static_cast<int>(x), oy = static_cast<int>(y);
    AggRas ras;
    for (const Vtx& v : outline) {
      if (v.cmd == CMD_MOVE_TO || is_vertex(v.cmd)) {
        // the cached scanlines moved by whole pixels: the same cells, moved
        int ix = iround(v.x * 256) + ox * 256, iy = iround(v.y * 256) + oy * 256;
        if (v.cmd == CMD_MOVE_TO) {
          ras.close_polygon();
          ras.sx_i = ras.last_x = ix;
          ras.sy_i = ras.last_y = iy;
        } else {
          ras.line(ras.last_x, ras.last_y, ix, iy);
          ras.last_x = ix;
          ras.last_y = iy;
          ras.open = true;
        }
      } else if (is_end_poly(v.cmd)) {
        ras.close_polygon();
      }
    }
    fill(canvas, W, H, ras, box, c);
  }
}

// RendererAgg::draw_text_image at angle 0: the (bh, bw) coverage bitmap
// with its bottom row above canvas row y, its left column at x, in color.
void plot_text_image(uint8_t* canvas, int W, int H, const uint8_t* bitmap, int bw, int bh, int x,
                     int y, const double* color) {
  int deltay = y - bh;
  int tx1 = std::max(x, 0), ty1 = std::max(deltay, 0);
  int tx2 = std::min(x + bw, W), ty2 = std::min(y, H);
  Rgba8 c = rgba8_of(color);
  if (tx2 <= tx1) return;
  for (int yi = ty1; yi < ty2; ++yi) {
    const uint8_t* cov = bitmap + static_cast<size_t>(yi - deltay) * bw + (tx1 - x);
    uint8_t* p = canvas + (static_cast<size_t>(yi) * W + tx1) * 4;
    for (int xi = tx1; xi < tx2; ++xi, p += 4, ++cov) blend_cover(p, c, *cov);
  }
}


}  // extern "C"

namespace {

// -- imshow's resample (matplotlib's _image_resample.h over Agg) --------------

// image_filter_lut for hanning: 14-bit weights at 1/256 steps over a
// diameter of 2, normalised so that every phase sums to 16384
struct HanningLut {
  int16_t w[512];
  HanningLut() {
    const unsigned diameter = 2, pivot = diameter << 7, end = (diameter << 8) - 1;
    for (unsigned i = 0; i < pivot; ++i) {
      double x = double(i) / 256.0;
      double y = 0.5 + 0.5 * std::cos(3.14159265358979323846 * x);
      w[pivot + i] = w[pivot - i] = static_cast<int16_t>(iround(y * 16384));
    }
    w[0] = w[end];
    int flip = 1;
    for (unsigned i = 0; i < 256; ++i) {
      for (;;) {
        int sum = 0;
        for (unsigned j = 0; j < diameter; ++j) sum += w[j * 256 + i];
        if (sum == 16384) break;
        double k = 16384.0 / double(sum);
        sum = 0;
        for (unsigned j = 0; j < diameter; ++j)
          sum += w[j * 256 + i] = static_cast<int16_t>(iround(w[j * 256 + i] * k));
        sum -= 16384;
        int inc = (sum > 0) ? -1 : 1;
        for (unsigned j = 0; j < diameter && sum; ++j) {
          flip ^= 1;
          unsigned idx = flip ? diameter / 2 + j / 2 : diameter / 2 - j / 2;
          int v = w[idx * 256 + i];
          if (v < 16384) {
            w[idx * 256 + i] = static_cast<int16_t>(w[idx * 256 + i] + inc);
            sum += inc;
          }
        }
      }
    }
    for (unsigned i = 0; i < pivot; ++i) w[pivot + i] = w[pivot - i];
    w[0] = w[end];
  }
};

struct Reflect {  // wrap_mode_reflect
  unsigned size, size2, add, value = 0;
  explicit Reflect(unsigned n) : size(n), size2(n * 2), add(size2 * (0x3FFFFFFF / size2)) {}
  unsigned operator()(int v) {
    value = (unsigned(v) + add) % size2;
    if (value >= size) return size2 - value - 1;
    return value;
  }
  unsigned next() {
    ++value;
    if (value >= size2) value = 0;
    if (value >= size) return size2 - value - 1;
    return value;
  }
};

struct Dda2 {  // dda2_line_interpolator
  int cnt, lft, rem, mod, y;
  Dda2(int y1, int y2, int count)
      : cnt(count <= 0 ? 1 : count), lft((y2 - y1) / cnt), rem((y2 - y1) % cnt), mod(rem), y(y1) {
    if (mod <= 0) {
      mod += count;
      rem += count;
      lft--;
    }
    mod -= count;
  }
  void next() {
    mod += rem;
    y += lft;
    if (mod > 0) {
      mod -= cnt;
      y++;
    }
  }
};

template <class T>
void resample_rgba(const T* in, int in_w, int in_h, T* out, int out_w, int out_h, const double* mtx,
                   int hanning) {
  Affine affine = Affine::from(mtx);
  if (hanning && std::fabs(affine.sx) == 1.0 && std::fabs(affine.sy) == 1.0 && affine.shx == 0.0 &&
      affine.shy == 0.0)
    hanning = 0;
  Affine inv = affine;
  inv.invert();
  // the coverage of the transformed input rectangle, clipped to the output
  AggRas ras;
  double px[4] = {0, double(in_w), double(in_w), 0}, py[4] = {0, 0, double(in_h), double(in_h)};
  for (int k = 0; k < 4; ++k) {
    double x = px[k], y = py[k];
    affine.transform(&x, &y);
    if (k == 0)
      ras.move_to(x, y);
    else
      ras.line_to(x, y);
  }
  std::vector<uint8_t> cover(static_cast<size_t>(out_w) * out_h, 0);
  ras.sweep(0, 0, out_w, out_h,
            [&](int x, int y, int a) { cover[static_cast<size_t>(y) * out_w + x] = uint8_t(a); });
  static const HanningLut lut;
  // span_image_resample_affine::prepare
  double scale_x = std::sqrt(inv.sx * inv.sx + inv.shx * inv.shx);
  double scale_y = std::sqrt(inv.shy * inv.shy + inv.sy * inv.sy);
  const double limit = 20.0;
  if (scale_x * scale_y > limit) {
    scale_x = scale_x * limit / (scale_x * scale_y);
    scale_y = scale_y * limit / (scale_x * scale_y);
  }
  if (scale_x < 1) scale_x = 1;
  if (scale_y < 1) scale_y = 1;
  if (scale_x > limit) scale_x = limit;
  if (scale_y > limit) scale_y = limit;
  int rx = int(uround(scale_x * 256.0)), rx_inv = int(uround(1.0 / scale_x * 256.0));
  int ry = int(uround(scale_y * 256.0)), ry_inv = int(uround(1.0 / scale_y * 256.0));
  const int diameter = 2, filter_scale = diameter << 8;
  int radius_x = (diameter * rx) >> 1, radius_y = (diameter * ry) >> 1;
  Reflect wx(in_w), wy(in_h);
  std::vector<T> span;
  for (int y = 0; y < out_h; ++y) {
    const uint8_t* cov = cover.data() + static_cast<size_t>(y) * out_w;
    int x = 0;
    while (x < out_w) {
      if (!cov[x]) {
        ++x;
        continue;
      }
      int x0 = x;
      while (x < out_w && cov[x]) ++x;
      int len = x - x0;
      // span_interpolator_linear::begin at the pixels' centres
      double tx = x0 + 0.5, ty = y + 0.5;
      inv.transform(&tx, &ty);
      int ix1 = iround(tx * 256), iy1 = iround(ty * 256);
      tx = x0 + 0.5 + len;
      ty = y + 0.5;
      inv.transform(&tx, &ty);
      int ix2 = iround(tx * 256), iy2 = iround(ty * 256);
      Dda2 lx(ix1, ix2, len), ly(iy1, iy2, len);
      T* dst = out + (static_cast<size_t>(y) * out_w + x0) * 4;
      for (int i = 0; i < len; ++i, lx.next(), ly.next(), dst += 4) {
        int sx = lx.y, sy = ly.y;
        T c[4];
        if (!hanning) {
          const T* p = in + (static_cast<size_t>(wy(sy >> 8)) * in_w + wx(sx >> 8)) * 4;
          for (int k = 0; k < 4; ++k) c[k] = p[k];
        } else {
          sx += 128 - radius_x;
          sy += 128 - radius_y;
          double fg[4] = {0, 0, 0, 0};
          int y_lr = sy >> 8;
          int y_hr = ((255 - (sy & 255)) * ry_inv) >> 8;
          int total = 0;
          int x_lr = sx >> 8;
          int x_hr2 = ((255 - (sx & 255)) * rx_inv) >> 8;
          int m_x = x_lr;
          const T* row = in + static_cast<size_t>(wy(y_lr)) * in_w * 4;
          const T* p = row + wx(m_x) * 4;
          for (;;) {
            int weight_y = lut.w[y_hr];
            int x_hr = x_hr2;
            for (;;) {
              int weight = (weight_y * lut.w[x_hr] + 8192) >> 14;
              for (int k = 0; k < 4; ++k) fg[k] += p[k] * weight;
              total += weight;
              x_hr += rx_inv;
              if (x_hr >= filter_scale) break;
              p = row + wx.next() * 4;
            }
            y_hr += ry_inv;
            if (y_hr >= filter_scale) break;
            row = in + static_cast<size_t>(wy.next()) * in_w * 4;
            p = row + wx(m_x) * 4;
          }
          for (int k = 0; k < 4; ++k) {
            fg[k] /= total;
            if (fg[k] < 0) fg[k] = 0;
          }
          if (fg[3] > 1.0) fg[3] = 1.0;
          for (int k = 0; k < 3; ++k)
            if (fg[k] > fg[3]) fg[k] = fg[3];
          for (int k = 0; k < 4; ++k) c[k] = static_cast<T>(fg[k]);
        }
        // copy_or_blend_pix into the zeroed output (blender_rgba_plain)
        unsigned cv = cov[x0 + i];
        if (c[3] <= 0) continue;
        if (c[3] >= 1 && cv == 255) {
          for (int k = 0; k < 4; ++k) dst[k] = c[k];
        } else {
          T alpha = static_cast<T>(c[3] * cv / 255);
          T a = dst[3];
          T r[3];
          for (int k = 0; k < 3; ++k) r[k] = dst[k] * a;
          for (int k = 0; k < 3; ++k) dst[k] = (1 - alpha) * r[k] + alpha * c[k];
          dst[3] = (1 - alpha) * a + alpha;
          for (int k = 0; k < 3; ++k) dst[k] = dst[3] == 0 ? 0 : dst[k] / dst[3];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// imshow's resample (matplotlib's _image.resample, resample=True, alpha 1):
// an (in_h, in_w, 4) RGBA image through the affine mtx (input pixels to
// output pixels, y up) into the zeroed (out_h, out_w, 4) output, hanning
// (1) or nearest (0); float32 when f64 is 0, else float64.
void plot_resample(const void* in, int in_w, int in_h, void* out, int out_w, int out_h,
                   const double* mtx, int hanning, int f64) {
  if (f64)
    resample_rgba(static_cast<const double*>(in), in_w, in_h, static_cast<double*>(out), out_w,
                  out_h, mtx, hanning);
  else
    resample_rgba(static_cast<const float*>(in), in_w, in_h, static_cast<float*>(out), out_w,
                  out_h, mtx, hanning);
}

// RendererAgg::draw_image: the (h, w, 4) uint8 image (rows from the bottom)
// put with its top-left pixel at canvas (x, y) (rows from the top; the
// caller rounds matplotlib's position half away from 0), inside
// the renderer's clip box from clip (x0, y0, x1, y1 in matplotlib's pixels,
// both ends included), blended where its alpha is below 255.
void plot_blend_image(uint8_t* canvas, int W, int H, const uint8_t* img, int w, int h, int x,
                      int y, const double* clip) {
  int cb[4] = {0, 0, W - 1, H - 1};
  if (clip && (clip[0] != 0.0 || clip[1] != 0.0 || clip[2] != 0.0 || clip[3] != 0.0)) {
    int x1 = std::max(static_cast<int>(std::floor(clip[0] + 0.5)), 0);
    int y1 = std::max(static_cast<int>(std::floor(H - clip[1] + 0.5)), 0);
    int x2 = std::min(static_cast<int>(std::floor(clip[2] + 0.5)), W);
    int y2 = std::min(static_cast<int>(std::floor(H - clip[3] + 0.5)), H);
    int bx1 = std::max(std::min(x1, x2), 0), bx2 = std::min(std::max(x1, x2), W - 1);
    int by1 = std::max(std::min(y1, y2), 0), by2 = std::min(std::max(y1, y2), H - 1);
    if (bx1 > bx2 || by1 > by2) return;
    cb[0] = bx1;
    cb[1] = by1;
    cb[2] = bx2;
    cb[3] = by2;
  }
  for (int r = 0; r < h; ++r) {
    int cy = y + r;
    if (cy < cb[1] || cy > cb[3]) continue;
    const uint8_t* src = img + static_cast<size_t>(h - 1 - r) * w * 4;
    for (int c = 0; c < w; ++c) {
      int cx = x + c;
      if (cx < cb[0] || cx > cb[2]) continue;
      const uint8_t* s = src + c * 4;
      uint8_t* p = canvas + (static_cast<size_t>(cy) * W + cx) * 4;
      if (s[3] == 0) continue;
      if (s[3] == 255) {
        std::memcpy(p, s, 4);
      } else {
        blend_pix(p, s[0], s[1], s[2], s[3]);
      }
    }
  }
}

}  // extern "C"
