// Dashboard.tsx: label-funnel stat tiles, pairwise progress, training
// status, needs-attention list, service health, live WS feed + tiles,
// and a polled throughput trend chart.
import {api, h, main, pct, fmt, esc, short, when, table, ws, sparkline,
        sevBadge} from "/static/app.js";

export default async function Dashboard() {
  const [hl, stats, cows, tp, vids, tstatus, elo] = await Promise.all([
    api("/api/health/overview"), api("/api/training/stats"),
    api("/api/cows/summary/stats"), api("/api/health/throughput"),
    api("/api/videos?limit=1000").then(r => r.videos),
    api("/api/training/status")
      .catch(() => ({status: "never_run"})),
    api("/api/elo/stats").catch(() => null)]);

  // label funnel (Dashboard.tsx metrics grid)
  const labeled = vids.filter(v => v.label != null).length;
  const sound = vids.filter(v => v.label === 0).length;
  const lame = vids.filter(v => v.label === 1).length;
  const analyzed = vids.filter(v => v.has_analysis).length;
  const pending = vids.filter(v => v.label == null);

  main.append(h(`<div class="grid">
    <div class="panel"><div class="dim">total videos</div>
      <div class="stat" id="t-total">${vids.length}</div></div>
    <div class="panel"><div class="dim">analyzed</div>
      <div class="stat" id="t-analyzed">${analyzed}</div>
      <div class="dim">${vids.length ? pct(analyzed / vids.length) : "—"}
        complete</div></div>
    <div class="panel"><div class="dim">labeled</div>
      <div class="stat">${labeled}</div>
      <div class="dim">${vids.length ? pct(labeled / vids.length) : "—"}
        complete</div></div>
    <div class="panel"><div class="dim">sound</div>
      <div class="stat ok">${sound}</div></div>
    <div class="panel"><div class="dim">lame</div>
      <div class="stat bad">${lame}</div></div>
    <div class="panel"><div class="dim">pending labels</div>
      <div class="stat">${pending.length}</div></div>
  </div>
  <div class="grid">
    <div class="panel"><div class="dim">videos analyzed (1h)</div>
      <div class="stat" id="t-hour">${tp.videos_analyzed}</div>
      <div class="dim">${fmt(tp.videos_per_hour, 1)}/h</div>
      <div id="trend"></div></div>
    <div class="panel"><div class="dim">pairwise comparisons</div>
      <div class="stat">${stats.pairwise_comparisons}</div>
      ${elo ? `<div class="dim">${elo.unique_raters} raters ·
        ${elo.videos_rated} rated</div>
      <div class="bar"><i style="width:${labeled > 1 ?
        Math.min(100, 100 * stats.pairwise_comparisons /
          (labeled * (labeled - 1) / 2)) : 0}%"></i></div>` : ""}</div>
    <div class="panel"><div class="dim">cows tracked</div>
      <div class="stat">${cows.total_cows}</div>
      <div class="dim">${cows.cows_with_lameness} with lameness</div></div>
    <div class="panel"><div class="dim">GBDT training</div>
      <div class="stat">${esc(tstatus.status || "never_run")}</div>
      <div class="dim">${tstatus.trained_at ? when(tstatus.trained_at)
        : `needs ${stats.min_new_videos} labeled`}</div></div>
    <div class="panel"><div class="dim">disk</div>
      <div class="stat ${hl.disk.status === 'healthy' ? 'ok' : 'warn'}">
        ${hl.disk.percent_used}%</div>
      <div class="dim">${hl.disk.free_gb} GB free</div></div>
    <div class="panel"><div class="dim">bus messages</div>
      <div class="stat" id="t-bus">${hl.bus.messages}</div>
      <div class="dim">${hl.bus.errors} errors · up
        ${fmt(hl.uptime_s / 60, 0)} min</div></div>
  </div>
  <div class="vs" style="align-items:flex-start">
    <div class="panel" style="flex:2"><h2>Recent videos</h2>
      <div id="recent"></div></div>
    <div class="panel" style="flex:1"><h2>Needs attention</h2>
      <div class="dim">videos requiring labels</div><div id="attn"></div>
      <button class="mini" onclick="go('videos')">label videos →</button>
    </div>
    <div class="panel" style="flex:1"><h2>Services</h2><div id="svc"></div>
      <h2 style="margin-top:12px">Live events</h2>
      <pre id="feed" style="max-height:140px">waiting…</pre></div>
  </div>`));

  document.getElementById("recent").innerHTML = vids.length
    ? table(vids.slice(0, 8), [
        ["video", v => `<span class="dim">${short(v.id)}</span> ${
          esc(v.original_filename || v.filename || "")}`],
        ["status", v => `<span class="badge">${esc(v.status)}</span>`],
        ["label", v => v.label == null ? "—" : v.label ? "lame" : "sound"],
        ["uploaded", v => `<span class="dim">${when(v.uploaded_at)}</span>`],
      ], {rowAttr: v => `class="click" onclick="go('analysis','${v.id}')"`})
    : `<span class="dim">no videos yet — try the Upload page</span>`;

  document.getElementById("attn").innerHTML = pending.length
    ? pending.slice(0, 5).map(v => `<div class="row click"
        onclick="go('analysis','${v.id}')">
        <span class="dim">${short(v.id, 10)}</span>
        <span>${esc(v.original_filename || v.filename || "")}</span>
      </div>`).join("")
    : `<div class="ok">all videos labeled ✓</div>`;

  const entries = Object.entries(hl.services);
  document.getElementById("svc").innerHTML = entries.length
    ? table(entries, [
        ["service", e => esc(e[0])],
        ["status", e => `<span class="${
          e[1] === 'healthy' ? 'ok' : 'bad'}">${esc(e[1])}</span>`]])
    : `<span class="dim">no heartbeats yet</span>`;

  // live updates: pipeline WS bumps tiles + feed; health/throughput poll
  // drives the trend sparkline (the reference polls every 30 s)
  const lines = [];
  const feed = document.getElementById("feed");
  let analyzedLive = analyzed;
  ws("pipeline", (msg) => {
    lines.unshift(`${new Date().toLocaleTimeString()}  ${msg.type || ""}  ${
      msg.video_id || ""}`);
    feed.textContent = lines.slice(0, 8).join("\n");
    if ((msg.type || "").includes("complete")) {
      analyzedLive += 1;
      const t = document.getElementById("t-analyzed");
      if (t) t.textContent = analyzedLive;
    }
  });
  const trendVals = [tp.videos_analyzed];
  const trendBox = document.getElementById("trend");
  trendBox.innerHTML = sparkline(trendVals, {w: 180, h: 36, ymin: 0});
  const poll = setInterval(async () => {
    if (!document.getElementById("trend")) return clearInterval(poll);
    try {
      const t = await api("/api/health/throughput");
      trendVals.push(t.videos_analyzed);
      if (trendVals.length > 30) trendVals.shift();
      document.getElementById("t-hour").textContent = t.videos_analyzed;
      document.getElementById("trend").innerHTML =
        sparkline(trendVals, {w: 180, h: 36, ymin: 0});
    } catch (e) { clearInterval(poll); }
  }, 10000);
}
