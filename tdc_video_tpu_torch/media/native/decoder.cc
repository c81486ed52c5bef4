// TPU-native media decode stage (C ABI, consumed via ctypes).
//
// Replaces the reference's decord dependency (video decode at 1 fps,
// the reference's tdc/train.py:588-594, eval/*.py) and its
// soundfile/librosa audio chain (tdc/audio_models/processor.py:38-64:
// read -> mono -> resample 16 kHz) with one FFmpeg-backed shared library:
//
//   tdc_decode_video(path, fps, max_dim, max_frames, ...) ->
//       RGB24 frames, aspect-preserving scaled so max(w, h) == max_dim
//       (pad-to-square happens later in Python, data/images.py), sampled at
//       `fps` by presentation timestamp.
//   tdc_decode_audio(path, rate, max_samples, ...) ->
//       mono float32 PCM at `rate` (16 kHz for BEATs).
//
// Build: media/build.py (g++ -O2 -shared, links libavformat/avcodec/
// swscale/swresample/avutil).  The host thread pool decodes while the TPU
// computes — this stage is the only non-JAX compute in the pipeline.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Media {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  int stream = -1;
};

// fast_flags bits for tdc_decode_video_mt: trade decode fidelity for speed.
enum {
  kSkipLoopFilter = 1,  // AVDISCARD_ALL loop filter (minor pixel drift)
  kSkipNonRef = 2,      // drop non-reference (B) frames entirely
};

int open_media(const char* path, enum AVMediaType type, Media* m,
               int fast_flags = 0) {
  if (avformat_open_input(&m->fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(m->fmt, nullptr) < 0) return -2;
  const AVCodec* codec = nullptr;
  m->stream = av_find_best_stream(m->fmt, type, -1, -1, &codec, 0);
  if (m->stream < 0 || !codec) return -3;
  m->dec = avcodec_alloc_context3(codec);
  if (!m->dec) return -4;
  if (avcodec_parameters_to_context(m->dec, m->fmt->streams[m->stream]->codecpar) < 0)
    return -5;
  m->dec->thread_count = 0;  // auto
  if (fast_flags & kSkipLoopFilter) m->dec->skip_loop_filter = AVDISCARD_ALL;
  if (fast_flags & kSkipNonRef) m->dec->skip_frame = AVDISCARD_NONREF;
  if (avcodec_open2(m->dec, codec, nullptr) < 0) return -6;
  return 0;
}

void close_media(Media* m) {
  if (m->dec) avcodec_free_context(&m->dec);
  if (m->fmt) avformat_close_input(&m->fmt);
}

}  // namespace

extern "C" {

// Probe: fills duration (sec), and for the video stream fps/width/height.
// Returns 0 on success.
int tdc_probe(const char* path, double* duration, double* fps, int* width,
              int* height, int* has_audio) {
  Media m;
  if (open_media(path, AVMEDIA_TYPE_VIDEO, &m) != 0) {
    close_media(&m);
    return -1;
  }
  AVStream* st = m.fmt->streams[m.stream];
  *duration = m.fmt->duration > 0 ? m.fmt->duration / (double)AV_TIME_BASE : 0.0;
  AVRational r = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
  *fps = r.den ? av_q2d(r) : 0.0;
  *width = m.dec->width;
  *height = m.dec->height;
  *has_audio =
      av_find_best_stream(m.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0) >= 0 ? 1 : 0;
  close_media(&m);
  return 0;
}

// Decode frames sampled at `fps`, scaled aspect-preserving so the longer side
// equals max_dim.  `out` must hold max_frames * out_h * out_w * 3 bytes where
// out_w/out_h are returned through the pointers (fixed for the whole clip).
// Returns number of frames written, or negative on error.
int tdc_decode_video(const char* path, double fps, int max_dim, int max_frames,
                     uint8_t* out, int* out_w, int* out_h,
                     double* timestamps) {
  Media m;
  if (open_media(path, AVMEDIA_TYPE_VIDEO, &m) != 0) {
    close_media(&m);
    return -1;
  }
  AVStream* st = m.fmt->streams[m.stream];
  double tb = av_q2d(st->time_base);

  int w = m.dec->width, h = m.dec->height;
  if (w <= 0 || h <= 0) {
    close_media(&m);
    return -2;
  }
  int ow, oh;
  if (w >= h) {
    ow = max_dim;
    oh = std::max(2, (int)((int64_t)h * max_dim / w) & ~1);
  } else {
    oh = max_dim;
    ow = std::max(2, (int)((int64_t)w * max_dim / h) & ~1);
  }
  *out_w = ow;
  *out_h = oh;
  const size_t frame_bytes = (size_t)ow * oh * 3;

  SwsContext* sws =
      sws_getContext(w, h, m.dec->pix_fmt, ow, oh, AV_PIX_FMT_RGB24,
                     SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!sws) {  // exotic/unsupported source pixel format
    close_media(&m);
    return -3;
  }
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();

  int n = 0;
  double next_t = 0.0;
  const double step = fps > 0 ? 1.0 / fps : 0.0;
  bool draining = false;
  while (n < max_frames) {
    if (!draining) {
      int r = av_read_frame(m.fmt, pkt);
      if (r < 0) {
        draining = true;
        avcodec_send_packet(m.dec, nullptr);
      } else if (pkt->stream_index != m.stream) {
        av_packet_unref(pkt);
        continue;
      } else {
        avcodec_send_packet(m.dec, pkt);
        av_packet_unref(pkt);
      }
    }
    int r;
    while ((r = avcodec_receive_frame(m.dec, frame)) == 0 && n < max_frames) {
      int64_t pts = frame->best_effort_timestamp;
      double t = pts == AV_NOPTS_VALUE ? next_t : pts * tb;
      if (t + 1e-9 >= next_t) {
        uint8_t* dst[1] = {out + (size_t)n * frame_bytes};
        int dst_ls[1] = {ow * 3};
        sws_scale(sws, frame->data, frame->linesize, 0, h, dst, dst_ls);
        if (timestamps) timestamps[n] = t;
        n++;
        next_t = (step > 0) ? next_t + step : t + 1e18;
      }
      av_frame_unref(frame);
    }
    if (draining && r != 0) break;
    if (r == AVERROR_EOF) break;
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  sws_freeContext(sws);
  close_media(&m);
  return n;
}

}  // extern "C"

namespace {

// Decode sample targets k in [k0, k1) (target time k/fps) into the shared
// output buffer.  Own demuxer+decoder per worker; seeks to the keyframe at or
// before the first target so workers never overlap decode work beyond one GOP.
struct RangeJob {
  const char* path = nullptr;
  double fps = 1.0;
  int ow = 0, oh = 0, src_w = 0, src_h = 0;
  int k0 = 0, k1 = 0;
  int base = 0;  // output slot of target k is (k - base)
  int fast_flags = 0;
  uint8_t* out = nullptr;       // [*, oh, ow, 3]
  double* timestamps = nullptr;
  uint8_t* filled = nullptr;
  int rc = 0;
};

void decode_range(RangeJob* job) {
  Media m;
  if (open_media(job->path, AVMEDIA_TYPE_VIDEO, &m, job->fast_flags) != 0) {
    close_media(&m);
    job->rc = -1;
    return;
  }
  AVStream* st = m.fmt->streams[m.stream];
  double tb = av_q2d(st->time_base);
  const double step = 1.0 / job->fps;
  // Warm-up targets: in the sequential one-target-per-frame scan a frame
  // near the slice boundary may already have been consumed by target k0-1
  // (when the local frame interval exceeds `step`), so a worker that starts
  // cold at k0 would re-emit it.  Consuming (and discarding) up to two
  // earlier targets reproduces the sequential consumption chain across the
  // boundary for gaps spanning up to two steps; sparser streams are routed
  // to the sequential decoder by the caller's avg-fps guard (rc -9).
  int k = job->k0 - std::min(2, job->k0);
  double target = k * step;

  if (k > 0) {
    int64_t pts = (int64_t)(target / tb);
    if (av_seek_frame(m.fmt, m.stream, pts, AVSEEK_FLAG_BACKWARD) >= 0) {
      avcodec_flush_buffers(m.dec);
    }  // unseekable container: decode from the start (slower, still correct)
  }

  SwsContext* sws = sws_getContext(m.dec->width, m.dec->height, m.dec->pix_fmt,
                                   job->ow, job->oh, AV_PIX_FMT_RGB24,
                                   SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!sws) {
    close_media(&m);
    job->rc = -3;
    return;
  }
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  const size_t frame_bytes = (size_t)job->ow * job->oh * 3;

  bool draining = false;
  while (k < job->k1) {
    if (!draining) {
      int r = av_read_frame(m.fmt, pkt);
      if (r < 0) {
        draining = true;
        avcodec_send_packet(m.dec, nullptr);
      } else if (pkt->stream_index != m.stream) {
        av_packet_unref(pkt);
        continue;
      } else {
        avcodec_send_packet(m.dec, pkt);
        av_packet_unref(pkt);
      }
    }
    int r;
    while ((r = avcodec_receive_frame(m.dec, frame)) == 0 && k < job->k1) {
      int64_t pts = frame->best_effort_timestamp;
      if (pts == AV_NOPTS_VALUE) {  // cannot place frames in time after a seek
        av_frame_unref(frame);
        job->rc = -7;
        goto done;
      }
      double t = pts * tb;
      if (t + 1e-9 >= target) {  // one target per frame (matches the
                                 // sequential sampler's semantics)
        if (k >= job->k0) {  // warm-up targets are consumed but not emitted
          uint8_t* dst[1] = {job->out + (size_t)(k - job->base) * frame_bytes};
          int dst_ls[1] = {job->ow * 3};
          sws_scale(sws, frame->data, frame->linesize, 0, m.dec->height, dst, dst_ls);
          if (job->timestamps) job->timestamps[k - job->base] = t;
          job->filled[k - job->base] = 1;
        }
        k++;
        target = k * step;
      }
      av_frame_unref(frame);
    }
    if (draining && r != 0) break;
    if (r == AVERROR_EOF) break;
  }
done:
  av_frame_free(&frame);
  av_packet_free(&pkt);
  sws_freeContext(sws);
  close_media(&m);
}

}  // namespace

extern "C" {

// Segment-parallel decode: N workers each seek to their time slice and decode
// one GOP-aligned range (replaces decord's threaded decode,
// the reference's tdc/train.py:588-594).  `fast_flags`: bit 0 skips the
// H.264/5 loop filter, bit 1 drops non-reference frames — both opt-in decode
// speedups for ingestion-bound hosts.  Falls back to a negative rc when the
// container cannot be time-sliced (caller then uses tdc_decode_video).
int tdc_decode_video_mt(const char* path, double fps, int max_dim,
                        int max_frames, int n_threads, int fast_flags,
                        uint8_t* out, int* out_w, int* out_h,
                        double* timestamps) {
  Media m;
  if (open_media(path, AVMEDIA_TYPE_VIDEO, &m) != 0) {
    close_media(&m);
    return -1;
  }
  int w = m.dec->width, h = m.dec->height;
  double dur = m.fmt->duration > 0 ? m.fmt->duration / (double)AV_TIME_BASE : 0.0;
  AVStream* vst = m.fmt->streams[m.stream];
  AVRational fr = vst->avg_frame_rate.num ? vst->avg_frame_rate : vst->r_frame_rate;
  double src_fps = fr.den > 0 ? av_q2d(fr) : 0.0;
  close_media(&m);
  if (w <= 0 || h <= 0) return -2;
  if (dur <= 0.0) return -8;  // unknown duration: cannot partition targets
  // Sparse-sampling guard: when the source frame interval approaches the
  // sample step, target->frame assignment depends on the consumption chain
  // from frame 0 (one-target-per-frame), which a seeking worker cannot
  // reconstruct beyond its warm-up window.  Route to sequential decode.
  if (src_fps > 0.0 && src_fps < 2.0 * fps) return -9;

  int ow, oh;
  if (w >= h) {
    ow = max_dim;
    oh = std::max(2, (int)((int64_t)h * max_dim / w) & ~1);
  } else {
    oh = max_dim;
    ow = std::max(2, (int)((int64_t)w * max_dim / h) & ~1);
  }
  *out_w = ow;
  *out_h = oh;

  int n_targets = std::min(max_frames, (int)(dur * fps) + 1);
  if (n_targets < 1) n_targets = 1;
  n_threads = std::max(1, std::min(n_threads, n_targets));

  std::vector<uint8_t> filled(n_targets, 0);
  std::vector<RangeJob> jobs(n_threads);
  int per = (n_targets + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; i++) {
    RangeJob& j = jobs[i];
    j.path = path;
    j.fps = fps;
    j.ow = ow;
    j.oh = oh;
    j.k0 = i * per;
    j.k1 = std::min(n_targets, (i + 1) * per);
    j.fast_flags = fast_flags;
    j.out = out;
    j.timestamps = timestamps;
    j.filled = filled.data();
  }
  std::vector<std::thread> workers;
  for (int i = 0; i < n_threads; i++)
    workers.emplace_back(decode_range, &jobs[i]);
  for (auto& t : workers) t.join();
  for (auto& j : jobs)
    if (j.rc == -7) return -7;  // untimestamped stream: caller falls back

  // Compact out any unfilled targets (EOF before the duration estimate).
  const size_t frame_bytes = (size_t)ow * oh * 3;
  int n = 0;
  for (int k = 0; k < n_targets; k++) {
    if (!filled[k]) continue;
    if (n != k) {
      std::memmove(out + (size_t)n * frame_bytes, out + (size_t)k * frame_bytes,
                   frame_bytes);
      if (timestamps) timestamps[n] = timestamps[k];
    }
    n++;
  }
  return n;
}

// Decode only sample targets [k0, k1) (streaming: chunk t+1 decodes while
// chunk t encodes on-device — serving/streaming.py).  Same fallback rcs as
// the mt entry (-7 untimestamped, -8 unknown duration).  Returns frames
// written (compacted at the front of `out`).
int tdc_decode_video_range(const char* path, double fps, int max_dim, int k0,
                           int k1, int fast_flags, uint8_t* out, int* out_w,
                           int* out_h, double* timestamps) {
  Media m;
  if (open_media(path, AVMEDIA_TYPE_VIDEO, &m) != 0) {
    close_media(&m);
    return -1;
  }
  int w = m.dec->width, h = m.dec->height;
  double dur = m.fmt->duration > 0 ? m.fmt->duration / (double)AV_TIME_BASE : 0.0;
  AVStream* vst = m.fmt->streams[m.stream];
  AVRational fr = vst->avg_frame_rate.num ? vst->avg_frame_rate : vst->r_frame_rate;
  double src_fps = fr.den > 0 ? av_q2d(fr) : 0.0;
  close_media(&m);
  if (w <= 0 || h <= 0) return -2;
  if (dur <= 0.0 && k0 > 0) return -8;
  // k0-independent (unlike the duration guard): a sparse container must
  // fall back for EVERY chunk, or a streaming caller would get chunk 0
  // sliced and chunk 1 refused mid-stream.
  if (src_fps > 0.0 && src_fps < 2.0 * fps) return -9;  // see mt guard

  int ow, oh;
  if (w >= h) {
    ow = max_dim;
    oh = std::max(2, (int)((int64_t)h * max_dim / w) & ~1);
  } else {
    oh = max_dim;
    ow = std::max(2, (int)((int64_t)w * max_dim / h) & ~1);
  }
  *out_w = ow;
  *out_h = oh;

  int n_range = k1 - k0;
  if (n_range <= 0) return 0;
  std::vector<uint8_t> filled(n_range, 0);
  RangeJob job;
  job.path = path;
  job.fps = fps;
  job.ow = ow;
  job.oh = oh;
  job.k0 = k0;
  job.k1 = k1;
  job.base = k0;
  job.fast_flags = fast_flags;
  job.out = out;
  job.timestamps = timestamps;
  job.filled = filled.data();
  decode_range(&job);
  if (job.rc == -7) return -7;

  const size_t frame_bytes = (size_t)ow * oh * 3;
  int n = 0;
  for (int i = 0; i < n_range; i++) {
    if (!filled[i]) continue;
    if (n != i) {
      std::memmove(out + (size_t)n * frame_bytes, out + (size_t)i * frame_bytes,
                   frame_bytes);
      if (timestamps) timestamps[n] = timestamps[i];
    }
    n++;
  }
  return n;
}

// Test-fixture encoder: writes `n_frames` synthetic frames at `fps` with the
// built-in MPEG-4 encoder (this environment ships no ffmpeg binary, and GIF
// fixtures are not seekable, so the segment-parallel decode path needs real
// timestamped video to test against).  Frame k is filled with
// (r, g, b) = (k % 256, (3 * k) % 256, 64) so decoded frames identify their
// source index.  Returns 0 on success.
int tdc_encode_test_video(const char* path, int w, int h, double fps,
                          int n_frames) {
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return -1;
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!codec) {
    avformat_free_context(fmt);
    return -2;
  }
  AVStream* st = avformat_new_stream(fmt, nullptr);
  AVCodecContext* enc = avcodec_alloc_context3(codec);
  enc->width = w;
  enc->height = h;
  enc->pix_fmt = AV_PIX_FMT_YUV420P;
  enc->time_base = av_d2q(1.0 / fps, 100000);
  enc->gop_size = 12;
  enc->bit_rate = 1000000;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  int rc = -3;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  if (avcodec_open2(enc, codec, nullptr) < 0) goto fail;
  avcodec_parameters_from_context(st->codecpar, enc);
  st->time_base = enc->time_base;
  if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
    goto fail;
  if (avformat_write_header(fmt, nullptr) < 0) goto fail;

  frame = av_frame_alloc();
  frame->format = enc->pix_fmt;
  frame->width = w;
  frame->height = h;
  av_frame_get_buffer(frame, 0);
  pkt = av_packet_alloc();

  for (int k = 0; k <= n_frames; k++) {
    AVFrame* f = nullptr;
    if (k < n_frames) {
      av_frame_make_writable(frame);
      // BT.601-ish constants are irrelevant; flat planes suffice for identity
      int r = k % 256, g = (3 * k) % 256, b = 64;
      int y = (int)(0.299 * r + 0.587 * g + 0.114 * b);
      int u = (int)(128 - 0.168736 * r - 0.331264 * g + 0.5 * b);
      int v = (int)(128 + 0.5 * r - 0.418688 * g - 0.081312 * b);
      std::memset(frame->data[0], std::clamp(y, 0, 255),
                  (size_t)frame->linesize[0] * h);
      std::memset(frame->data[1], std::clamp(u, 0, 255),
                  (size_t)frame->linesize[1] * (h / 2));
      std::memset(frame->data[2], std::clamp(v, 0, 255),
                  (size_t)frame->linesize[2] * (h / 2));
      frame->pts = k;
      f = frame;
    }
    if (avcodec_send_frame(enc, f) < 0) goto fail;
    int r2;
    while ((r2 = avcodec_receive_packet(enc, pkt)) == 0) {
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
      av_packet_unref(pkt);
    }
    if (r2 != AVERROR(EAGAIN) && r2 != AVERROR_EOF) goto fail;
  }
  av_write_trailer(fmt);
  rc = 0;
fail:
  if (frame) av_frame_free(&frame);
  if (pkt) av_packet_free(&pkt);
  avcodec_free_context(&enc);
  if (fmt->pb && !(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return rc;
}

// Decode the audio stream to mono float32 at `rate`.  Returns samples
// written, 0 if no audio stream, negative on error.
long tdc_decode_audio(const char* path, int rate, long max_samples,
                      float* out) {
  Media m;
  if (open_media(path, AVMEDIA_TYPE_AUDIO, &m) != 0) {
    close_media(&m);
    return 0;  // no audio stream
  }

  SwrContext* swr = nullptr;
  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  AVChannelLayout in_layout;
  if (m.dec->ch_layout.nb_channels > 0) {
    av_channel_layout_copy(&in_layout, &m.dec->ch_layout);
  } else {
    av_channel_layout_default(&in_layout, 1);
  }
  if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, rate, &in_layout,
                          m.dec->sample_fmt, m.dec->sample_rate, 0,
                          nullptr) < 0 ||
      swr_init(swr) < 0) {
    close_media(&m);
    return -1;
  }

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  long n = 0;
  std::vector<float> buf;
  bool draining = false;
  while (n < max_samples) {
    if (!draining) {
      int r = av_read_frame(m.fmt, pkt);
      if (r < 0) {
        draining = true;
        avcodec_send_packet(m.dec, nullptr);
      } else if (pkt->stream_index != m.stream) {
        av_packet_unref(pkt);
        continue;
      } else {
        avcodec_send_packet(m.dec, pkt);
        av_packet_unref(pkt);
      }
    }
    int r;
    while ((r = avcodec_receive_frame(m.dec, frame)) == 0 && n < max_samples) {
      int max_out = swr_get_out_samples(swr, frame->nb_samples);
      buf.resize(std::max(1, max_out));
      uint8_t* outp[1] = {(uint8_t*)buf.data()};
      int got = swr_convert(swr, outp, (int)buf.size(),
                            (const uint8_t**)frame->extended_data,
                            frame->nb_samples);
      if (got > 0) {
        long take = std::min((long)got, max_samples - n);
        std::memcpy(out + n, buf.data(), take * sizeof(float));
        n += take;
      }
      av_frame_unref(frame);
    }
    if (draining && r != 0) {
      // flush the resampler
      buf.resize(4096);
      uint8_t* outp[1] = {(uint8_t*)buf.data()};
      int got;
      while ((got = swr_convert(swr, outp, (int)buf.size(), nullptr, 0)) > 0 &&
             n < max_samples) {
        long take = std::min((long)got, max_samples - n);
        std::memcpy(out + n, buf.data(), take * sizeof(float));
        n += take;
      }
      break;
    }
    if (r == AVERROR_EOF) break;
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  swr_free(&swr);
  close_media(&m);
  return n;
}

}  // extern "C"
