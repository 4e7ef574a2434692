// TPU-native replacement for decord's C++ video reader.
//
// The reference does all video decode through decord's VideoReader
// (videollama2/mm_utils.py:154-177: open, get_avg_fps, len, get_batch).
// This library provides the same capability over FFmpeg's libavformat/
// libavcodec/libswscale with a C ABI consumed via ctypes
// (videollama2_tpu/media/video_reader.py).
//
// Design: seek-and-decode exactly the K requested frame indices. For each
// sorted index we av_seek to the nearest prior keyframe and decode forward,
// reusing the decode position when the next index is close (sequential reads
// never re-seek). Output is packed RGB24 [N, H, W, 3], written into a
// caller-provided buffer so numpy owns the allocation (zero extra copies on
// the Python side).
//
// Build: media/csrc/Makefile -> libvideodec.so

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/pixdesc.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <string>
#include <vector>

namespace {

struct VDContext {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  int stream_idx = -1;
  int width = 0;
  int height = 0;
  double fps = 0.0;
  int64_t num_frames = 0;
  AVRational time_base{1, 1};
  int64_t start_time = 0;
  // decode cursor: next frame number the decoder will emit, -1 = unknown
  int64_t cursor = -1;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  std::string error;
};

int64_t pts_to_frame(const VDContext* c, int64_t pts) {
  if (pts == AV_NOPTS_VALUE) return -1;
  double sec = (pts - c->start_time) * av_q2d(c->time_base);
  return (int64_t)(sec * c->fps + 0.5);
}

int64_t frame_to_pts(const VDContext* c, int64_t frame) {
  double sec = frame / c->fps;
  return c->start_time + (int64_t)(sec / av_q2d(c->time_base) + 0.5);
}

}  // namespace

extern "C" {

VDContext* vd_open(const char* path) {
  auto* c = new VDContext();
  if (avformat_open_input(&c->fmt, path, nullptr, nullptr) < 0) {
    delete c;
    return nullptr;
  }
  if (avformat_find_stream_info(c->fmt, nullptr) < 0) {
    avformat_close_input(&c->fmt);
    delete c;
    return nullptr;
  }
  c->stream_idx = av_find_best_stream(c->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                      nullptr, 0);
  if (c->stream_idx < 0) {
    avformat_close_input(&c->fmt);
    delete c;
    return nullptr;
  }
  AVStream* st = c->fmt->streams[c->stream_idx];
  const AVCodec* dec = avcodec_find_decoder(st->codecpar->codec_id);
  if (!dec) {
    avformat_close_input(&c->fmt);
    delete c;
    return nullptr;
  }
  c->codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(c->codec, st->codecpar);
  c->codec->thread_count = 2;  // matches decord num_threads=2 (mm_utils.py:154)
  c->codec->thread_type = FF_THREAD_FRAME;
  if (avcodec_open2(c->codec, dec, nullptr) < 0) {
    avcodec_free_context(&c->codec);
    avformat_close_input(&c->fmt);
    delete c;
    return nullptr;
  }
  c->width = c->codec->width;
  c->height = c->codec->height;
  c->time_base = st->time_base;
  c->start_time = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;
  AVRational afr = st->avg_frame_rate;
  if (afr.num == 0 || afr.den == 0) afr = st->r_frame_rate;
  c->fps = (afr.num && afr.den) ? av_q2d(afr) : 25.0;
  c->num_frames = st->nb_frames;
  if (c->num_frames <= 0) {
    int64_t dur = st->duration;
    if (dur > 0) {
      c->num_frames = (int64_t)(dur * av_q2d(c->time_base) * c->fps + 0.5);
    } else if (c->fmt->duration > 0) {
      c->num_frames =
          (int64_t)((double)c->fmt->duration / AV_TIME_BASE * c->fps + 0.5);
    }
  }
  c->frame = av_frame_alloc();
  c->pkt = av_packet_alloc();
  return c;
}

void vd_close(VDContext* c) {
  if (!c) return;
  if (c->sws) sws_freeContext(c->sws);
  if (c->frame) av_frame_free(&c->frame);
  if (c->pkt) av_packet_free(&c->pkt);
  if (c->codec) avcodec_free_context(&c->codec);
  if (c->fmt) avformat_close_input(&c->fmt);
  delete c;
}

long vd_num_frames(VDContext* c) { return (long)c->num_frames; }
double vd_fps(VDContext* c) { return c->fps; }
int vd_width(VDContext* c) { return c->width; }
int vd_height(VDContext* c) { return c->height; }

namespace {

// Decode the next frame from the stream; returns frame number or -1 on EOF.
int64_t decode_next(VDContext* c) {
  while (true) {
    int ret = avcodec_receive_frame(c->codec, c->frame);
    if (ret == 0) {
      int64_t pts = c->frame->best_effort_timestamp;
      int64_t fn = pts_to_frame(c, pts);
      if (fn < 0) fn = c->cursor;  // no pts: trust the cursor
      c->cursor = fn + 1;
      return fn;
    }
    if (ret == AVERROR_EOF) return -1;
    if (ret != AVERROR(EAGAIN)) return -1;
    // feed more packets
    while (true) {
      ret = av_read_frame(c->fmt, c->pkt);
      if (ret < 0) {
        avcodec_send_packet(c->codec, nullptr);  // flush
        break;
      }
      if (c->pkt->stream_index == c->stream_idx) {
        ret = avcodec_send_packet(c->codec, c->pkt);
        av_packet_unref(c->pkt);
        if (ret == 0) break;
        if (ret != AVERROR(EAGAIN)) return -1;
      } else {
        av_packet_unref(c->pkt);
      }
    }
  }
}

bool seek_to(VDContext* c, int64_t frame_idx) {
  int64_t pts = frame_to_pts(c, frame_idx);
  if (av_seek_frame(c->fmt, c->stream_idx, pts, AVSEEK_FLAG_BACKWARD) < 0)
    return false;
  avcodec_flush_buffers(c->codec);
  c->cursor = -1;
  return true;
}

void write_rgb(VDContext* c, uint8_t* dst) {
  c->sws = sws_getCachedContext(
      c->sws, c->frame->width, c->frame->height,
      (AVPixelFormat)c->frame->format, c->width, c->height, AV_PIX_FMT_RGB24,
      SWS_BILINEAR, nullptr, nullptr, nullptr);
  uint8_t* dst_data[4] = {dst, nullptr, nullptr, nullptr};
  int dst_linesize[4] = {3 * c->width, 0, 0, 0};
  sws_scale(c->sws, c->frame->data, c->frame->linesize, 0, c->frame->height,
            dst_data, dst_linesize);
}

// Scale + (optionally center-crop) the current frame straight to packed
// I420 at (S x S) — the host->device wire format (media/wire.py): Y plane
// [S, S] then the U and V planes, S*S/4 bytes each, in one contiguous
// [S*3/2, S] buffer. The video never leaves YUV: no host RGB round trip,
// half the resize work of the RGB path, and the output range is forced to
// FULL (JPEG) so the device unpack's full-range BT.601 inverse applies to
// limited-range sources too (sws_setColorspaceDetails dstRange=1).
//
// clip_crop=1 reproduces CLIP preprocessing semantics (shortest-edge
// resize + center crop == scale the centered min(W,H) square to S x S);
// clip_crop=0 is SigLIP's plain stretch resize.
bool write_i420(VDContext* c, int S, int clip_crop, uint8_t* dst) {
  AVFrame* f = c->frame;
  // stage 1: scale shortest-edge (or stretch) to an intermediate I420
  int iw = S, ih = S;
  if (clip_crop) {
    if (f->width <= f->height)
      ih = (int)((int64_t)S * f->height / f->width);
    else
      iw = (int)((int64_t)S * f->width / f->height);
    // chroma planes need even dims
    iw += iw & 1;
    ih += ih & 1;
  }
  // ACCURATE_RND + FULL_CHR_H_INT disable swscale's unscaled special
  // converters, which ignore sws_setColorspaceDetails — without them a
  // same-size RGB source comes out LIMITED range (primaries clip at 235)
  c->sws = sws_getCachedContext(
      c->sws, f->width, f->height, (AVPixelFormat)f->format, iw, ih,
      AV_PIX_FMT_YUV420P,
      SWS_BICUBIC | SWS_ACCURATE_RND | SWS_FULL_CHR_H_INT, nullptr, nullptr,
      nullptr);
  if (!c->sws) return false;
  // The wire's device-side inverse is full-range BT.601; most streams are
  // limited-range. swscale CANNOT be trusted to do the range expansion:
  // its unscaled converters (chosen e.g. for same-size yuv420p sources)
  // silently ignore sws_setColorspaceDetails. So the range never changes
  // inside sws (srcRange == dstRange — range expansion is affine, and
  // bicubic resampling is linear, so expanding AFTER the scale is
  // equivalent up to +-1 rounding), and limited sources are expanded to
  // full range by an exact LUT pass over the small scaled planes below.
  // RGB sources are always full range regardless of the (usually unset)
  // color_range field.
  const AVPixFmtDescriptor* desc =
      av_pix_fmt_desc_get((AVPixelFormat)f->format);
  int src_range = (f->color_range == AVCOL_RANGE_JPEG ||
                   (desc && (desc->flags & AV_PIX_FMT_FLAG_RGB)))
                      ? 1
                      : 0;
  const int* coefs = sws_getCoefficients(SWS_CS_ITU601);
  sws_setColorspaceDetails(c->sws, coefs, src_range, coefs, src_range, 0,
                           1 << 16, 1 << 16);
  std::vector<uint8_t> tmp((size_t)iw * ih * 3 / 2);
  uint8_t* tdata[4] = {tmp.data(), tmp.data() + (size_t)iw * ih,
                       tmp.data() + (size_t)iw * ih + (size_t)(iw / 2) *
                                        (ih / 2),
                       nullptr};
  int tls[4] = {iw, iw / 2, iw / 2, 0};
  sws_scale(c->sws, f->data, f->linesize, 0, f->height, tdata, tls);

  if (!src_range) {
    // limited (studio) -> full range: Y (x-16)*255/219, C (x-128)*255/224
    // + 128, clipped — C++11 magic statics make the LUT init thread-safe
    static const auto luts = [] {
      struct {
        uint8_t y[256], c[256];
      } t;
      for (int i = 0; i < 256; ++i) {
        int y = (int)((i - 16) * 255.0 / 219.0 + 0.5);
        int cc = (int)((i - 128) * 255.0 / 224.0 +
                       (i >= 128 ? 128.5 : 127.5));
        t.y[i] = (uint8_t)std::min(255, std::max(0, y));
        t.c[i] = (uint8_t)std::min(255, std::max(0, cc));
      }
      return t;
    }();
    uint8_t* yp = tmp.data();
    for (size_t i = 0; i < (size_t)iw * ih; ++i) yp[i] = luts.y[yp[i]];
    uint8_t* cp = tmp.data() + (size_t)iw * ih;
    for (size_t i = 0; i < (size_t)iw * ih / 2; ++i) cp[i] = luts.c[cp[i]];
  }

  // stage 2: centered S x S crop, plane-wise, into the packed wire layout.
  // Offsets round DOWN to even: 4:2:0 chroma rows/cols exist only at even
  // luma coordinates, so an odd offset would shift chroma half a sample
  // against luma. Cost: up to 1 px left/up of PIL's exact (iw-S)/2 center
  // — a documented wire delta (PARITY.md), NOT a bug to "fix" with odd
  // offsets.
  int x0 = ((iw - S) / 2) & ~1;
  int y0 = ((ih - S) / 2) & ~1;
  uint8_t* dy = dst;
  uint8_t* du = dst + (size_t)S * S;
  uint8_t* dv = du + (size_t)S * S / 4;
  for (int r = 0; r < S; ++r)
    std::memcpy(dy + (size_t)r * S, tdata[0] + (size_t)(y0 + r) * iw + x0, S);
  for (int r = 0; r < S / 2; ++r) {
    std::memcpy(du + (size_t)r * (S / 2),
                tdata[1] + (size_t)(y0 / 2 + r) * (iw / 2) + x0 / 2, S / 2);
    std::memcpy(dv + (size_t)r * (S / 2),
                tdata[2] + (size_t)(y0 / 2 + r) * (iw / 2) + x0 / 2, S / 2);
  }
  return true;
}

}  // namespace

namespace {

// Shared seek-and-decode batch loop: calls `emit(frame_slot)` for every
// requested index once the decoder is positioned on (or past) it.
// (std::function, not a template: this block lives inside extern "C".)
int batch_loop(VDContext* c, const long* indices, int n, size_t frame_bytes,
               uint8_t* out, const std::function<bool(uint8_t*)>& emit) {
  int written = 0;
  int64_t last_decoded = -1;
  bool have_frame = false;
  for (int i = 0; i < n; ++i) {
    int64_t target = indices[i];
    if (have_frame && last_decoded == target) {
      // duplicate index: copy previous output
      std::memcpy(out + (size_t)written * frame_bytes,
                  out + (size_t)(written - 1) * frame_bytes, frame_bytes);
      ++written;
      continue;
    }
    // Re-seek when jumping backwards or far forwards (> ~4s of frames).
    int64_t gap_limit = (int64_t)(c->fps * 4) + 1;
    if (c->cursor < 0 || target < c->cursor ||
        target > c->cursor + gap_limit) {
      if (!seek_to(c, target)) {
        // fall back to sequential from start
        if (!seek_to(c, 0)) return written;
      }
    }
    int64_t fn;
    bool got = false;
    // decode forward until we reach (or pass) the target
    while ((fn = decode_next(c)) >= 0) {
      if (fn >= target) {
        got = true;
        break;
      }
    }
    if (!got) {
      // EOF before target (truncated stream): reuse last good frame if any
      if (!have_frame) return written;
    } else {
      last_decoded = fn;
      have_frame = true;
    }
    if (!emit(out + (size_t)written * frame_bytes)) return written;
    ++written;
  }
  return written;
}

}  // namespace

// Decode frames at `indices` (ascending) into out [n, h, w, 3] uint8.
// Returns number of frames written (== n on success).
int vd_get_batch(VDContext* c, const long* indices, int n, uint8_t* out) {
  const size_t frame_bytes = (size_t)c->width * c->height * 3;
  return batch_loop(c, indices, n, frame_bytes, out, [&](uint8_t* dst) {
    write_rgb(c, dst);
    return true;
  });
}

// Decode frames at `indices` (ascending), scale (+ center-crop when
// clip_crop) straight to packed full-range I420 at S x S, into out
// [n, S*3/2, S] uint8 — the host->device wire buffer (media/wire.py),
// produced without ever materializing RGB on the host. Returns the number
// of frames written (== n on success). S must be a multiple of 4.
int vd_get_batch_i420(VDContext* c, const long* indices, int n, int S,
                      int clip_crop, uint8_t* out) {
  if (S < 4 || (S % 4) != 0) return 0;
  const size_t frame_bytes = (size_t)S * S * 3 / 2;
  return batch_loop(c, indices, n, frame_bytes, out, [&](uint8_t* dst) {
    return write_i420(c, S, clip_crop, dst);
  });
}

// ---------------------------------------------------------------------------
// Audio-track decode: the VideoLLaMA2.1-AV workload consumes the audio
// stream of the video file itself (reference README.md:130-132; the AV
// branch decodes audio from the same mp4). Decode the container's best
// audio stream and resample to `target_rate` Hz mono float32 via
// libswresample — the BEATs frontend's expected input (media/audio.py).
//
// One-shot API: the full track is decoded into a malloc'd buffer (minutes
// of 16 kHz f32 are a few MB; eval clips are short). Caller frees with
// ad_free. Returns the sample count, or -1 when the container has no
// audio stream / cannot be decoded.
// ---------------------------------------------------------------------------

long ad_decode(const char* path, int target_rate, float** out) {
  *out = nullptr;
  AVFormatContext* fmt = nullptr;
  AVCodecContext* cc = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  long result = -1;
  std::vector<float> buf;
  std::vector<float> tmp;

  do {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) break;
    if (avformat_find_stream_info(fmt, nullptr) < 0) break;
    int si = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
    if (si < 0) break;
    AVStream* st = fmt->streams[si];
    const AVCodec* dec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!dec) break;
    cc = avcodec_alloc_context3(dec);
    if (!cc || avcodec_parameters_to_context(cc, st->codecpar) < 0) break;
    if (avcodec_open2(cc, dec, nullptr) < 0) break;
    if (cc->sample_rate <= 0) break;
    if (cc->ch_layout.nb_channels == 0)
      av_channel_layout_default(&cc->ch_layout, 1);
    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, target_rate,
                            &cc->ch_layout, cc->sample_fmt, cc->sample_rate,
                            0, nullptr) < 0 ||
        swr_init(swr) < 0)
      break;
    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    if (!pkt || !frame) break;

    auto drain = [&](const AVFrame* f) {
      int in_n = f ? f->nb_samples : 0;
      int max_out = swr_get_out_samples(swr, in_n);
      if (max_out <= 0) return;
      tmp.resize((size_t)max_out);
      uint8_t* outp[1] = {reinterpret_cast<uint8_t*>(tmp.data())};
      int n = swr_convert(swr, outp, max_out,
                          f ? const_cast<const uint8_t**>(f->extended_data)
                            : nullptr,
                          in_n);
      if (n > 0) buf.insert(buf.end(), tmp.begin(), tmp.begin() + n);
    };

    while (av_read_frame(fmt, pkt) >= 0) {
      if (pkt->stream_index == si && avcodec_send_packet(cc, pkt) == 0) {
        while (avcodec_receive_frame(cc, frame) == 0) drain(frame);
      }
      av_packet_unref(pkt);
    }
    avcodec_send_packet(cc, nullptr);  // flush the decoder
    while (avcodec_receive_frame(cc, frame) == 0) drain(frame);
    drain(nullptr);                    // flush the resampler tail

    result = (long)buf.size();
    if (result > 0) {
      *out = (float*)malloc((size_t)result * sizeof(float));
      if (!*out) {
        result = -1;
        break;
      }
      std::memcpy(*out, buf.data(), (size_t)result * sizeof(float));
    }
  } while (false);

  if (frame) av_frame_free(&frame);
  if (pkt) av_packet_free(&pkt);
  if (swr) swr_free(&swr);
  if (cc) avcodec_free_context(&cc);
  if (fmt) avformat_close_input(&fmt);
  return result;
}

void ad_free(float* p) { free(p); }

// Returns 1 when the container has a decodable audio stream, 0 otherwise.
int ad_has_audio(const char* path) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return 0;
  int has = 0;
  if (avformat_find_stream_info(fmt, nullptr) >= 0) {
    has = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0)
          >= 0;
  }
  avformat_close_input(&fmt);
  return has;
}

}  // extern "C"
